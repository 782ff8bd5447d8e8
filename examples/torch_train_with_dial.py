"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps with the data pipeline ingesting through the
DIAL-tuned simulated PFS.

Run:  PYTHONPATH=src python examples/torch_train_with_dial.py \
          [--steps 200] [--device cpu]

The counterpart of ``examples/train_with_dial.py``, with the same model
(``demo-100m``), sizes and printout.  Checkpoints go to ``--ckpt-dir``
every 50 steps without being pushed through the sim's write path
(``ckpt_through_pfs=False``): through it, host 0's writes queue behind
its own ingest reader and every save runs ``pfs_write``'s 200,000-tick
guard, in both packages (ROADMAP Queue 3, reference fault 6).  The CUDA
card is the default device; without one this raises unless ``--device
cpu`` is given.
"""

import argparse
import os

from repro_torch import resolve_device
from repro_torch.launch.train import train
from repro_torch.train.optimizer import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "dial_demo_ckpt"))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                    "PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # demo-100m lives in repro_torch/configs/demo_100m.py (~100M params)
    out = train("demo-100m", steps=args.steps, batch=args.batch,
                seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                ckpt_every=50, dial_model_path="models/dial",
                log_every=20, device=dev, ckpt_through_pfs=False)
    n = sum(p.numel() for p in tree_leaves(out["params"]))
    print(f"\ntrained {n / 1e6:.0f}M params for {args.steps} steps")
    print(f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}; "
          f"ingest {out['ingest_mbs']:.0f} MB/s (DIAL-tuned); "
          f"{out['wall_s']:.1f} s wall on {dev}")


if __name__ == "__main__":
    main()
