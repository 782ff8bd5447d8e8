"""ctypes binding of ``csrc/flash_attention.cu`` (see its header note).

One call, three launch forms, picked by :func:`attention_form` from Sq and
the dtype: ``decode`` (bf16, Sq = 1: split-KV partials and an ordered
combine), ``mma`` (bf16 prefill on tensor cores) and ``cuda_core``
(float32, any Sq).  ``decode`` and ``cuda_core`` can also write each
row's log-sum-exp; ``mma`` cannot, and refuses the request.  ``LAUNCHES["flash_attention"]`` counts one per call; the
decode form's combine launch counts under ``flash_attention_combine``.
A bf16 head dim of 8 (the smoke configs of starcoder2-15b and
llava-next-34b) runs the D = 16 instantiation on q, k and v padded with
zero columns, which add nothing to q.k and give zero output columns; the
scale stays D's.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch.kernels import LAUNCHES, refuse_grad

HEAD_DIMS = (8, 16, 32, 64, 128, 160, 256)   # the float32 form's
MMA_HEAD_DIMS = (16, 32, 64, 128, 160, 256)  # the bf16 forms' (k-steps of 16)
DECODE_KEYS = 64    # the decode form's largest split (keys staged per block)
DECODE_HEADS = 16   # q-heads of one GQA group per decode block
MIN_SPLIT = 16      # the decode form's smallest split, but for the last
MAX_SPLITS = 4096   # splits the combine stages in shared memory, at most
_DTYPES = (torch.float32, torch.bfloat16)
_fns: dict = {}
_sms: dict = {}


def _entry(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("flash_attention"), name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {
            "flash_attention_fwd": [i32] + [ptr] * 5 + [i32] * 6 + [ptr]
            + [i32] * 2 + [f32] * 2 + [ptr],
            "flash_attention_decode": [ptr] * 5 + [i32] * 5 + [ptr]
            + [i32] * 3 + [f32] * 2 + [ptr],
            "flash_attention_combine": [ptr] * 4 + [i32] * 4
            + [ctypes.c_longlong] * 2 + [ptr],
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def attention_form(sq: int, dtype: torch.dtype) -> str:
    """The launch form for ``sq`` queries of ``dtype``: ``decode``,
    ``mma`` or ``cuda_core``."""
    if dtype != torch.bfloat16:
        return "cuda_core"
    return "decode" if sq == 1 else "mma"


def decode_splits(band: int, rows: int, n_sm: int) -> tuple[int, int]:
    """``(splits, keys per split)`` for a decode launch over ``band`` live
    keys with ``rows`` blocks per split (batch x kv-heads x head chunks):
    enough splits for two blocks per SM, each of ``MIN_SPLIT`` to
    ``DECODE_KEYS`` keys (a multiple of ``MIN_SPLIT``), none empty."""
    if band < 1 or rows < 1 or n_sm < 1:
        raise ValueError(f"decode_splits: band={band}, rows={rows}, "
                         f"n_sm={n_sm}")
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    splits = min(max(cdiv(band, DECODE_KEYS), cdiv(2 * n_sm, rows)),
                 cdiv(band, MIN_SPLIT))
    length = min(DECODE_KEYS, MIN_SPLIT * cdiv(band, MIN_SPLIT * splits))
    return cdiv(band, length), length


def _sm_count(dev) -> int:
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _aligned(*tensors) -> bool:
    """Each starts on 16 bytes with (batch, head, sequence) strides of a
    multiple of 16 bytes: what the 16-byte copies take."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
               for t in tensors)


def _check(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softcap: float = 0.0, return_lse: bool = False):
    """Launch the attention kernel in the form :func:`attention_form` picks.

    q ``(B, Hq, Sq, D)``, k/v ``(B, Hkv, Skv, D)``, one dtype (float32 or
    bfloat16), any strides with a contiguous last axis (a cache slice is
    passed as a view); the decode and bf16 forms also need 16-byte aligned
    q/k/v rows.  Returns ``(B, Hq, Sq, D)`` in q's dtype, laid
    out ``(B, Sq, Hq, D)`` in memory (a transposed view); with
    ``return_lse`` also each row's float32 log-sum-exp ``(B, Hq, Sq)``
    (``-inf`` for a row with no key), which the decode and float32 forms
    give and the bf16 prefill form refuses (``ValueError``).  Raises
    ``RuntimeError`` on inputs that require a gradient (the kernel has
    no backward).
    """
    refuse_grad("flash_attention_cuda", q, k, v)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda: q on {dev}, k on "
                         f"{k.device}, v on {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda: q, k, v must share a "
                         f"float32 or bfloat16 dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv or d not in HEAD_DIMS \
            or sq < 1 or skv < 1 or b * hq > 65535:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} not taken (head dims "
                         f"{HEAD_DIMS}, Hq % Hkv == 0)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda: the head axis must be "
                         "contiguous")
    form = attention_form(sq, q.dtype)
    if return_lse and form == "mma":
        raise ValueError("flash_attention_cuda: the bf16 prefill (mma) "
                         "form gives no log-sum-exp; the decode (bf16, "
                         "Sq = 1) and float32 forms do")
    scale = float(d ** -0.5)
    if form != "cuda_core" and d not in MMA_HEAD_DIMS:
        widen = lambda t: F.pad(t, (0, 16 - d))  # noqa: E731
        res = _launch(form, widen(q), widen(k), widen(v), causal, window,
                      softcap, scale, return_lse)
        return (res[0][..., :d], res[1]) if return_lse else res[..., :d]
    if form != "cuda_core" and not _aligned(q, k, v):
        raise ValueError("flash_attention_cuda: q/k/v rows must start on "
                         "16-byte boundaries (decode and bf16 forms)")
    return _launch(form, q, k, v, causal, window, softcap, scale, return_lse)


def _launch(form, q, k, v, causal, window, softcap, scale, return_lse=False):
    dev = q.device
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    window = int(window or 0)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if form == "decode":
        k_begin = max(0, skv - window) if window > 0 else 0
        rows = b * hkv * -(-(hq // hkv) // DECODE_HEADS)
        splits, length = decode_splits(skv - k_begin, rows, _sm_count(dev))
        if splits > MAX_SPLITS:
            raise ValueError(f"flash_attention_cuda: {skv - k_begin} live "
                             f"keys need {splits} splits, the decode form "
                             f"takes {MAX_SPLITS}")
        part_o = torch.empty((b * hq, splits, d), dtype=torch.float32,
                             device=dev)
        part_ml = torch.empty((b * hq, splits, 2), dtype=torch.float32,
                              device=dev)
        strides = (ctypes.c_longlong * 8)(
            *q.stride()[:2], *k.stride()[:3], *v.stride()[:3])
        _check(_entry("flash_attention_decode")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), b, hq, hkv, skv, d,
            ctypes.addressof(strides), k_begin, splits, length,
            float(softcap), scale, stream), "flash_attention_decode")
        LAUNCHES["flash_attention"] += 1
        lse = torch.empty((b, hq, 1), dtype=torch.float32,
                          device=dev) if return_lse else None
        _check(_entry("flash_attention_combine")(
            part_o.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, hq,
            d, splits, out.stride(0), out.stride(1), stream),
            "flash_attention_combine")
        LAUNCHES["flash_attention_combine"] += 1
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lse = torch.empty((b, hq, sq), dtype=torch.float32,
                      device=dev) if return_lse else None
    _check(_entry("flash_attention_fwd")(
        1 if form == "mma" else 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, hq, hkv,
        sq, skv, d, ctypes.addressof(strides), int(causal), window,
        float(softcap), scale, stream), "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out
