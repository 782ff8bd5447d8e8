"""Batched serving example on the PyTorch/CUDA port: prefill a prompt
batch and decode new tokens for three different architecture families
(dense / hybrid / SSM).

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]

The counterpart of ``examples/serve_batch.py``, with the same models
(smoke configs), sizes and printout.  The CUDA card is the default
device; without one this raises unless ``--device cpu`` is given.
"""

import argparse

from repro_torch import resolve_device
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                    "PyTorch versions")
    dev = resolve_device(ap.parse_args(argv).device)
    for arch in ("gemma2-2b", "recurrentgemma-9b", "falcon-mamba-7b"):
        out = serve(arch, batch=4, prompt_len=24, gen_tokens=12, device=dev)
        print(f"{arch:20s}: generated {tuple(out['tokens'].shape)}, "
              f"prefill {out['prefill_s']:.2f}s, "
              f"{out['tok_per_s']:.1f} tok/s decode (smoke config, {dev})")


if __name__ == "__main__":
    main()
