"""Kernel K2q8: one-token decode attention over the int8 KV cache on Hopper
(CUDA C++, sm_90a). Source: ``csrc/flash_decode_q8.cu``.

The JAX package computes this step with XLA (``quorum_tpu/ops/attention.py:
decode_attention_q8``; it has no Pallas kernel): the port writes it by hand
because its decode attention is a hand-written kernel (K2) and PyTorch has
no batched int8 product on CUDA. Same function as the plain version
(ops/attention.py ``decode_attention_q8``): q [B, H, 1, hd] against the
int8 cache k8 / v8 [B, K, T, hd] with per-token f32 scales [B, K, T], row b
attending ``[lengths[b] − W, lengths[b])``, GQA by index; q and the
probabilities are quantized amax/127 and both contractions are exact
integer sums; V's scales are folded into the probabilities, which take one
scale over the row's whole live range.

What bounds it on the H100: bytes — the live int8 rows and their scales,
Σ live · K · (2·hd + 8). Three launches per call on the caller's stream, a
fixed grid (n_splits, K, B) with K2's split rule (``decode_n_splits``,
``decode_split_plan``): logits and per-split softmax partials (max, sum,
max of exp·vs) into scratch; every block merges its row's partials, so all
of them quantize the probabilities with the row's one scale, and sums
p8·v8 in int32 (``__dp4a``); a last launch adds the splits' integer sums
and rescales. No tile gets a scale of its own: that would be another
function.

Scratch (the logits [B, H, T] f32, the partials, the int32 sums and the
probability scales) is cached per device, stream and shape under a lock,
like K2's. ``launches`` counts calls that launched (one per call), exactly
under concurrent callers; a call made while its thread captures a CUDA
graph counts as captured and is added per replay (``ops/launches.py``).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback and no switch that turns it off.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from quorum_tpu_torch.ops import cuda_build, launches
from quorum_tpu_torch.ops.attention import _int_dot, decode_attention_q8, q8_probabilities
from quorum_tpu_torch.ops.flash_decode import (_DTYPE_CODES, MAX_GROUP, SUPPORTED_HEAD_DIMS,
                                               decode_n_splits)

_SCRATCH: dict[tuple, tuple[torch.Tensor, ...]] = {}
_LOCK = threading.Lock()
# The kernel's probabilities p·vs/ps agree with the plain version's within
# a few f32 ulps (its softmax merges split partials in another order, with
# one more exp per merge); this relative margin covers them ten times over.
PROB_REL = 1e-5


def _lib():
    lib = cuda_build.load("flash_decode_q8")
    fn = lib.qt_flash_decode_q8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def _scratch(device, stream, b, h, t, hd, n_splits):
    """Logits, split partials, int32 partial sums and probability scales of
    one shape on one stream of one device (``stream``: its handle), made
    once and reused by every later call on that stream."""
    key = (device, stream, b, h, t, hd, n_splits)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        with _LOCK:
            bufs = _SCRATCH.get(key)
            if bufs is None:
                bufs = _SCRATCH[key] = (
                    torch.empty((b * h * t,), dtype=torch.float32, device=device),
                    torch.empty((b * h * n_splits * 3,), dtype=torch.float32, device=device),
                    torch.empty((b * h * n_splits * hd,), dtype=torch.int32, device=device),
                    torch.empty((b * h,), dtype=torch.float32, device=device))
    return bufs


def _check(q, k8, ks, v8, vs, lengths, window):
    if q.dim() != 4 or q.shape[2] != 1 or k8.dim() != 4 or k8.shape != v8.shape:
        raise ValueError(f"expected q [B,H,1,hd], cache [B,K,T,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k8.shape)}, {tuple(v8.shape)}")
    b, h, _, hd = q.shape
    n_kv, t = k8.shape[1], k8.shape[2]
    if k8.shape[0] != b or k8.shape[3] != hd or h % n_kv:
        raise ValueError(f"cache {tuple(k8.shape)} does not match q {tuple(q.shape)}")
    if ks.shape != (b, n_kv, t) or vs.shape != (b, n_kv, t):
        raise ValueError(f"scales must be [B,K,T]={(b, n_kv, t)}, got {tuple(ks.shape)}, "
                         f"{tuple(vs.shape)}")
    if h // n_kv > MAX_GROUP:
        raise ValueError(f"{h // n_kv} query heads per kv head; the kernel holds {MAX_GROUP}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype}: need one of float32, bfloat16")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8 or ks.dtype != torch.float32 \
            or vs.dtype != torch.float32:
        raise ValueError(f"cache dtypes {k8.dtype}/{v8.dtype}, scales {ks.dtype}/{vs.dtype}: "
                         "need int8 values and float32 scales")
    for name, x in (("q", q), ("k8", k8), ("k_scale", ks), ("v8", v8), ("v_scale", vs),
                    ("lengths", lengths)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k8.data_ptr() % 16 or v8.data_ptr() % 16:
        raise ValueError("k8 and v8 must be 16-byte aligned (vector loads)")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B]={b}, got {tuple(lengths.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_decode_q8_attention(
    q: torch.Tensor,        # [B, H, 1, hd] bf16/f32
    k8: torch.Tensor,       # [B, K, T, hd] int8
    k_scale: torch.Tensor,  # [B, K, T] f32
    v8: torch.Tensor,       # [B, K, T, hd] int8
    v_scale: torch.Tensor,  # [B, K, T] f32
    lengths: torch.Tensor,  # [B]: valid entries per row, including the current token
    window: int = 0,
) -> torch.Tensor:
    """Decode attention over the int8 cache. Returns [B, H, 1, hd] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_q8(q, k8, k_scale, v8, v_scale, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_q8_attention runs on cuda or cpu, not {q.device}")
    lengths = lengths.to(torch.int32).contiguous()
    _check(q, k8, k_scale, v8, v_scale, lengths, window)
    b, h, _, hd = q.shape
    n_kv, t = k8.shape[1], k8.shape[2]
    n_splits = decode_n_splits(b, n_kv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    logits, part, part_acc, pscale = _scratch(q.device, stream, b, h, t, hd, n_splits)
    out = torch.empty_like(q)
    err = _lib().qt_flash_decode_q8(
        q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(), v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), logits.data_ptr(), part.data_ptr(),
        part_acc.data_ptr(), pscale.data_ptr(), b, h, n_kv, t, hd, window, n_splits,
        hd ** -0.5, _DTYPE_CODES[q.dtype], stream)
    cuda_build.check(err, "flash_decode_q8")
    launches.count(flash_decode_q8_attention)
    return out


flash_decode_q8_attention.launches = 0


def error_bound(q, k8, k_scale, v8, v_scale, lengths, window: int = 0) -> torch.Tensor:
    """The largest |kernel − plain version| a correct K2q8 may show, per
    output element ([B, H, 1, hd] f32), computed from the plain version's
    own probabilities on the same inputs. Only an entry of p·vs/ps within
    ``PROB_REL`` of a half-integer may quantize one step apart, and moves
    output d by ps·|v8[t, d]|: the bound sums that over those entries,
    adds ``PROB_REL``·|out| for the scale and the f32 rounding, and for a
    bf16 q one bf16 ulp of the output. A dropped or extra key moves an
    output by ps·p8_t·|v8[t, d]| and exceeds it."""
    b, h, s, d = q.shape
    pv, p8, ps = q8_probabilities(q, k8, k_scale, v_scale, lengths, window)
    u = pv / ps
    near = (u - torch.floor(u) - 0.5).abs() <= PROB_REL * u.abs().clamp_min(1.0)
    flips = _int_dot("bkgst,bktd->bkgsd", near.to(torch.int8), v8.abs()) * ps
    out = (_int_dot("bkgst,bktd->bkgsd", p8, v8) * ps).abs()
    bound = flips + PROB_REL * out
    if q.dtype == torch.bfloat16:
        bound = bound + out * 2.0 ** -7
    return bound.reshape(b, h, s, d)
