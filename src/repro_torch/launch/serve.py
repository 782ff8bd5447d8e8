"""Batched serving: prefill a batch of prompts, decode new tokens
greedily, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b [--full]

Mirrors ``repro/launch/serve.py`` for all ten families
(:data:`repro_torch.configs.ARCHS`).  Weights are random, drawn with the
reference's init formulas from a ``torch.Generator`` seeded by ``seed``
(other numbers than JAX's from the same seed).  A codebook model
(musicgen-large) takes prompts (B, S, K) and decodes tokens (B, T, K); a
VLM (llava-next-34b) gets random bf16 image embeddings (B, img_tokens,
D) before its prompt, as the reference's vision-tower stub.

``serve(..., mesh=mesh)`` serves over a ``DeviceMesh`` (one process per
card, the process group initialised by the caller;
:func:`repro_torch.launch.mesh.make_test_mesh`): the weights placed by
``param_pspecs``, the prompts over the data axes when the batch divides
them (else replicated, the attention caches then sharded on their
sequence), every step through the sharded prefill and decode steps.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.distributed.constrain import full
from repro_torch.models import lm
from repro_torch.train.steps import make_decode_step, make_prefill_step


def generate(params, prompts, cfg, gen_tokens: int, max_len: int,
             img_embeds=None) -> dict:
    """Prefill ``prompts`` (B, S[, K]) after ``img_embeds`` (B, I, D), if
    given, and decode ``gen_tokens`` greedy tokens (the first from the
    prefill logits), on the prompts' device; the first decode position
    is I + S.  With DTensor parameters and prompts it runs over their
    mesh, and the results come back whole on every rank.

    Returns ``tokens`` (B, gen_tokens[, K]) int64 on the host,
    ``prefill_s`` and ``decode_s`` (host clock, the device synchronized
    before each reading), and the float32 ``prefill_logits`` (B, 1, [K,]
    V) and last decode ``logits``.
    """
    dev = prompts.device

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    prefill_step = make_prefill_step(cfg, max_len)
    decode_step = make_decode_step(cfg)
    with torch.inference_mode():
        t0 = clock()
        logits, cache = prefill_step(params, prompts, img_embeds)
        prefill_s = clock() - t0
        prefill_logits = logits
        cur = prompts.shape[1] + (0 if img_embeds is None
                                  else img_embeds.shape[1])
        tok = logits.argmax(dim=-1)                        # (B, 1[, K])
        out = [tok]
        t0 = clock()
        for i in range(gen_tokens - 1):
            logits, cache = decode_step(params, tok, cache, cur + i)
            tok = logits.argmax(dim=-1)
            out.append(tok)
        decode_s = clock() - t0
    return {"tokens": full(torch.cat(out, dim=1)).cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "prefill_logits": full(prefill_logits), "logits": full(logits)}


def serve(arch: str, batch: int = 4, prompt_len: int = 32,
          gen_tokens: int = 16, smoke: bool = True, seed: int = 0,
          greedy: bool = True, device=None, mesh=None) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen_tokens`` each; ``device=None`` is the card.  With ``mesh`` the
    weights and prompts (drawn as without it, on this rank's card) are
    placed on the mesh and served over it.  Returns :func:`generate`'s
    dict plus ``tok_per_s`` (decode steps x batch per second)."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is served")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = lm.init_params(cfg, gen, dev)
    max_len = prompt_len + gen_tokens + (cfg.img_tokens or 0)
    shape = (batch, prompt_len) + ((cfg.num_codebooks,)
                                   if cfg.num_codebooks else ())
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                            device=dev)
    img = None
    if cfg.family == "vlm":
        img = torch.randn((batch, cfg.img_tokens, cfg.d_model),
                          generator=gen, device=dev, dtype=torch.bfloat16)
    if mesh is not None:
        params, prompts, img = place_on_mesh(params, prompts, img, mesh)
    out = generate(params, prompts, cfg, gen_tokens, max_len,
                   img_embeds=img)
    out["tok_per_s"] = batch * (gen_tokens - 1) / max(out["decode_s"], 1e-9)
    return out


def place_on_mesh(params, prompts, img_embeds, mesh):
    """Parameters by ``param_pspecs`` (validated), prompts and image
    embeddings over the data axes when the batch divides them, else
    replicated: DTensors on ``mesh``.  The parameter tree's leaves are
    replaced in place, each whole tensor dropped once its shard is made
    (the peak holds one leaf twice, not the model)."""
    from repro_torch.distributed import sharding as shd

    def place(tree, specs):
        for k in (tree if isinstance(tree, dict) else range(len(tree))):
            if isinstance(specs[k], shd.PartitionSpec):
                tree[k] = shd.distribute(tree[k], mesh, specs[k])
            else:
                place(tree[k], specs[k])
    place(params, shd.validate_pspecs(shd.param_pspecs(params), params,
                                      mesh))
    dp = 1
    for a in shd.dp_axes(mesh):
        dp *= shd.axis_sizes(mesh)[a]
    rows = shd.batch_pspec(mesh) if prompts.shape[0] % dp == 0 else (None,)
    ins = {"tokens": prompts}
    if img_embeds is not None:
        ins["img"] = img_embeds
    ins = shd.distribute(ins, mesh, {k: shd.P(*rows, *(None,) * (
        v.dim() - 1)) for k, v in ins.items()})
    return params, ins["tokens"], ins.get("img")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen_tokens=args.gen_tokens, smoke=not args.full)
    print(f"[serve] generated {out['tokens'].shape} tokens; "
          f"prefill {out['prefill_s']:.2f}s, "
          f"{out['tok_per_s']:.1f} tok/s decode")


if __name__ == "__main__":
    main()
