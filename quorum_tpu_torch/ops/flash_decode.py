"""Kernel K2: one-token decode attention over the slot KV cache on Hopper
(CUDA C++, sm_90a).

Replaces the Pallas TPU kernel ``quorum_tpu/ops/flash_decode.py:
_decode_kernel`` (launched by ``_decode_call``, dispatched by
``flash_decode_attention``). Source: ``csrc/flash_decode.cu``.

Same function as the plain version (ops/attention.py ``decode_attention``):
q [B, H, 1, hd] against the cache [B, K, T, hd], row b attending positions
``[lengths[b] − W, lengths[b])`` (the whole prefix without a window), GQA by
index. In the port this is the decode attention of every layer of every
step (the JAX package had its kernel opt-in).

What bounds it on the H100: bytes. Each live cache row is read once for all
G query heads of its kv head, ≈ Σ live · K · hd · 2 · sizeof(dtype) bytes,
against a few FLOPs per byte. One launch per call: a fixed grid (B, K,
n_splits) whose blocks size their own chunk of their row's live range on the
device (``decode_split_plan`` mirrors the rule) and stream it through a
shared-memory ring with asynchronous copies; the last block of a (row, kv
head) merges the partials through an atomic ticket and resets its counter
to 0. A short slot co-batched with a long one stops at its own length, and
the host never reads the lengths. Two routes (``decode_route``):

- ``mma`` (bf16): TMA-loaded 64-key K/V tiles with 128-byte swizzle; each
  compute warp runs S = Q·Kᵀ and O += P·V for 16 keys as ``mma.sync``
  m16n8k16 with the G query heads as rows, so a key costs a few
  instructions and the copies, not the math, set the pace.
- ``fma`` (f32; ``mma`` on f32 inputs would be TF32): 1-D bulk copies, FMA
  dot products shared across the G heads, shuffle reductions.

Scratch: the partial (m, l, acc) buffers and the ticket counters are cached
per device, stream and shape (``_scratch``) rather than allocated per call.
Calls on one stream are ordered, so they may share a set; calls on two
streams never do (several engines on one card, each on its own stream). The
counters are 0 between calls. ``launches`` counts kernel launches exactly
under concurrent callers (one scheduler thread per engine). A call made
while its thread captures a CUDA graph launches nothing yet: it counts as
captured, and whoever replays the graph adds its launches per replay
(``ops/launches.py``).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback and no switch that turns it off.
The kernel has no backward: under grad mode, inputs that require grad are
refused on both devices (``ops/attention.refuse_autograd``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from quorum_tpu_torch.ops import cuda_build, launches
from quorum_tpu_torch.ops.attention import decode_attention, refuse_autograd

SUPPORTED_HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8  # query heads per kv head one block holds (csrc GMAX)
MIN_CHUNK = 64  # keys: the least work one block takes (csrc MIN_CHUNK)
MAX_SPLITS = 32  # blocks per (row, kv head) at most (csrc MAX_SPLITS)
N_SMS = 132  # streaming multiprocessors of an H100 SXM
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SCRATCH: dict[tuple, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
_LOCK = threading.Lock()  # guards _SCRATCH inserts


def decode_route(dtype: torch.dtype) -> str:
    """The kernel variant a CUDA call of this dtype takes (the C entry
    point's dispatch makes the same choice)."""
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"dtype {dtype}: need one of float32, bfloat16")


def decode_n_splits(batch: int, n_kv: int) -> int:
    """Blocks per (row, kv head): enough that B·K·n_splits covers the card
    twice over, between 16 and 32. Shapes only — never the lengths."""
    return min(MAX_SPLITS, max(16, -(-2 * N_SMS // (batch * n_kv))))


def decode_split_plan(length: int, cache_len: int, n_splits: int,
                      window: int = 0) -> list[tuple[int, int]]:
    """The key range [begin, end) each of a row's ``n_splits`` blocks
    covers, as ``csrc/flash_decode.cu`` split_range computes it on the
    device; an idle block gets ``(begin, begin)``. The live range is
    [max(n − W, 0), n) with n = clamp(length, 0, cache_len); each chunk is
    ceil(live / n_splits) rounded up to a multiple of ``MIN_CHUNK`` (at least
    ``MIN_CHUNK``), so a short row uses one block. Block 0 is always active:
    for a row with no live key it writes zeros."""
    n = min(max(length, 0), cache_len)
    lo = max(n - window, 0) if window > 0 else 0
    live = n - lo
    chunk = -(-live // n_splits)
    chunk = max(MIN_CHUNK, -(-chunk // MIN_CHUNK) * MIN_CHUNK)
    n_act = max(1, -(-live // chunk))
    plan = []
    for sp in range(n_splits):
        begin = lo + sp * chunk
        plan.append((begin, min(begin + chunk, n)) if sp < n_act else (begin, begin))
    return plan


def _lib():
    lib = cuda_build.load("flash_decode")
    fn = lib.qt_flash_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def _scratch(device, stream, b, h, n_kv, hd, n_splits):
    """Partial (m, l) and acc buffers and the zeroed ticket counters of one
    shape on one stream of one device (``stream``: the stream's handle),
    made once and reused by every later call on that stream."""
    key = (device, stream, b, h, n_kv, hd, n_splits)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        with _LOCK:
            bufs = _SCRATCH.get(key)
            if bufs is None:
                bufs = _SCRATCH[key] = (
                    torch.empty((b * h * n_splits * 2,), dtype=torch.float32, device=device),
                    torch.empty((b * h * n_splits * hd,), dtype=torch.float32, device=device),
                    torch.zeros((b * n_kv,), dtype=torch.int32, device=device))
    return bufs


def _count_launch() -> None:
    launches.count(flash_decode_attention)


def ticket_counters() -> list[torch.Tensor]:
    """Every cached ticket-counter buffer (each must read 0 between calls)."""
    with _LOCK:
        return [bufs[2] for bufs in _SCRATCH.values()]


def _check(q, k_cache, v_cache, lengths, window):
    if q.dim() != 4 or q.shape[2] != 1 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"expected q [B,H,1,hd], cache [B,K,T,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, _, hd = q.shape
    n_kv = k_cache.shape[1]
    if k_cache.shape[0] != b or k_cache.shape[3] != hd or h % n_kv:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if h // n_kv > MAX_GROUP:
        raise ValueError(f"{h // n_kv} query heads per kv head; the kernel holds {MAX_GROUP}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: need one of "
                         "float32, bfloat16")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not lengths and t.data_ptr() % 16:  # lengths: plain int32 loads
            raise ValueError(f"{name} must be 16-byte aligned (asynchronous copies)")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B]={b}, got {tuple(lengths.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_decode_attention(
    q: torch.Tensor,        # [B, H, 1, hd]
    k_cache: torch.Tensor,  # [B, K, T, hd]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B]: valid entries per row, including the current token
    window: int = 0,
) -> torch.Tensor:
    """Per-row-exact decode attention. Returns [B, H, 1, hd]. Refuses
    grad-requiring inputs under grad mode."""
    refuse_autograd("flash_decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention(q, k_cache, v_cache, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention runs on cuda or cpu, not {q.device}")
    lengths = lengths.to(torch.int32).contiguous()
    _check(q, k_cache, v_cache, lengths, window)
    b, h, _, hd = q.shape
    n_kv, t = k_cache.shape[1], k_cache.shape[2]
    n_splits = decode_n_splits(b, n_kv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_ml, part_acc, tickets = _scratch(q.device, stream, b, h, n_kv, hd, n_splits)
    out = torch.empty_like(q)
    err = _lib().qt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(), tickets.data_ptr(),
        b, h, n_kv, t, hd, window, n_splits, hd ** -0.5,
        _DTYPE_CODES[q.dtype], stream)
    cuda_build.check(err, "flash_decode")
    _count_launch()
    return out


flash_decode_attention.launches = 0
