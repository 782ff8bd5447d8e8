"""End-to-end LM training with DIAL in its data path.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b [--full] [--steps 6 --batch 4 --seq-len 2048]

Mirrors ``repro/launch/train.py``: the model (any of the ten families,
full or smoke config; a VLM fed zero image embeddings, as the
reference's), AdamW, the DIAL-tuned data pipeline through the
simulated PFS, the checkpoint manager (save/restore through the PFS
write path) and resume.  Parameters are random, drawn with the
reference's init formulas from a ``torch.Generator`` seeded by ``seed``;
the tokens are the reference's (seeded numpy).  ``device=None`` is the
card.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.model import DIALModel
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.steps import make_train_step


def train(arch: str, steps: int = 50, smoke: bool = True,
          batch: int = 8, seq_len: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 25, dial_model_path: str | None = "models/dial",
          n_hosts: int = 4, grad_accum: int = 1, seed: int = 0,
          resume: bool = True, log_every: int = 10,
          peak_lr: float | None = None, device=None,
          dial_model: DIALModel | None = None,
          ckpt_through_pfs: bool = True) -> dict:
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``
    when ``resume``).  ``dial_model`` (on ``device``) tunes the pipeline;
    without it, ``dial_model_path`` is loaded if it exists.

    ``ckpt_through_pfs=False`` saves checkpoints without pushing them
    through the sim's write path.  With it (the reference's only way),
    host 0's checkpoint writes on OST 0 queue behind its own ingest
    reader there, which dispatches first, so the dirty cache never
    drains and ``pfs_write`` runs its 200,000-tick guard (1,000 sim
    seconds) every save (ROADMAP Queue 3, reference fault 6).

    Returns the reference's dict (``losses``, ``params``, ``opt_state``,
    ``pipeline``, ``wall_s``, ``ingest_mbs``) plus ``records``: per step
    its loss, grad norm, lr, ``next_batch_ms`` and ``step_ms`` (host
    clock, the device synchronized before each reading), the DIAL
    decisions and ingest MB/s so far and, on the card, the peak GiB
    allocated so far.
    """
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    dial = dial_model
    if dial is None and dial_model_path:
        try:
            dial = DIALModel.load(dial_model_path, device=dev)
        except FileNotFoundError:
            print("[train] no DIAL model found; pipeline runs untuned")

    pipe = DataPipeline(PipelineConfig(
        global_batch=batch, seq_len=seq_len, vocab_size=cfg.vocab_size,
        n_hosts=n_hosts, num_codebooks=cfg.num_codebooks, seed=seed),
        dial_model=dial, device=dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = lm.init_params(cfg, gen, dev)
    opt_state = init_opt_state(params)
    # Short smoke runs need a schedule that can move the weights: scale
    # the peak up for smoke runs under ~200 steps (capped at 1e-2); full
    # configs train at 3e-4 unless peak_lr is passed.  A resumed run
    # replays the same lrs when it keeps ``steps``.
    if peak_lr is None:
        peak_lr = 3e-4
        if smoke:
            peak_lr = float(min(1e-2, 3e-4 * max(1.0, 200.0 / max(steps, 1))))
    opt_cfg = AdamWConfig(peak_lr=peak_lr, min_lr=peak_lr / 10.0,
                          total_steps=steps,
                          warmup_steps=max(steps // 20, 5))
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=grad_accum)

    mgr = None
    start = 0
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, sim=pipe.sim,
                                hosts=list(range(n_hosts)), cfg=cfg)
        if resume:
            restored = mgr.restore_latest(params, opt_state)
            if restored is not None:
                start, params, opt_state, meta = restored
                pipe.load_state_dict(meta.get("extra", {}).get(
                    "pipeline", {"step_index": start}))
                print(f"[train] resumed from step {start}")

    losses, records = [], []
    t0 = time.time()
    img = None
    if cfg.family == "vlm":      # the vision tower's stub: zero embeddings
        img = torch.zeros((batch, cfg.img_tokens, cfg.d_model),
                          dtype=torch.bfloat16, device=dev)
    for step in range(start, steps):
        t_a = clock()
        np_batch = pipe.next_batch()
        t_b = clock()
        tbatch = {k: torch.as_tensor(v, device=dev).long()
                  for k, v in np_batch.items()}
        if img is not None:
            tbatch["img_embeds"] = img
        params, opt_state, metrics = step_fn(params, opt_state, tbatch)
        losses.append(float(metrics["loss"]))
        t_c = clock()
        records.append(dict(
            step=step, loss=losses[-1],
            grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
            next_batch_ms=(t_b - t_a) * 1e3, step_ms=(t_c - t_b) * 1e3,
            decisions=sum(len(a.decisions) for a in pipe.agents),
            ingest_mbs=pipe.ingest_throughput() / 1e6))
        if dev.type == "cuda":
            records[-1]["peak_gib"] = torch.cuda.max_memory_allocated(
                dev) / 2**30
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {records[-1]['grad_norm']:.3f} "
                  f"ingest {records[-1]['ingest_mbs']:.0f} MB/s")
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, params, opt_state,
                     extra={"pipeline": pipe.state_dict()},
                     through_pfs=ckpt_through_pfs)

    return {"losses": losses, "params": params, "opt_state": opt_state,
            "pipeline": pipe, "wall_s": time.time() - t0,
            "ingest_mbs": pipe.ingest_throughput() / 1e6,
            "records": records}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--dial-model", default="models/dial")
    ap.add_argument("--no-dial", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, smoke=not args.full,
                batch=args.batch, seq_len=args.seq_len,
                ckpt_dir=args.ckpt_dir, grad_accum=args.grad_accum,
                dial_model_path=None if args.no_dial else args.dial_model,
                seed=args.seed)
    print(f"[train] done: final loss {out['losses'][-1]:.4f}, "
          f"{out['wall_s']:.1f}s wall, ingest {out['ingest_mbs']:.0f} MB/s")


if __name__ == "__main__":
    main()
