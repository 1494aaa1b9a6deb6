"""Kernel K1: causal prefill attention on Hopper (CUDA C++, sm_90a).

Replaces the Pallas TPU kernel ``quorum_tpu/ops/flash_attention.py:
_flash_kernel`` (launched by ``_flash_call``, dispatched by
``flash_prefill_attention``). Source: ``csrc/flash_prefill.cu``.

Same function as the plain version (ops/attention.py ``prefill_attention``)
on every row below a row's length: q [B, H, S, hd] against k/v [B, K, S, hd],
GQA by index, keys at col ≥ ``lengths[b]`` masked, optional sliding window
``col > row − W``. Unlike the JAX kernel it takes any S (the ragged last tile
is masked in the kernel). **Every row at or past ``lengths[b]`` comes out as
exactly 0** (the plain version attends them to the live keys): such rows are
the right padding of a prompt bucket, which the model never reads (``prefill``
keeps row ``lengths − 1``), and a query tile that starts at or past the length
writes its zeros without doing any attention work.

What bounds it on the H100: operations. The work is 4·H·(kept query/key
pairs)·hd FLOPs over ≈ (2·H + 2·K)·S·hd elements of traffic, far above the
card's ~295 FLOP/byte ridge once S is in the hundreds. Two routes, chosen by
dtype and head dim here (``prefill_route``) and passed to the C entry point,
which refuses a route that cannot run the call:

- ``wgmma`` (bf16, hd 64 or 128): tensor cores. A persistent grid (one
  block per SM) takes 128-row query tiles heaviest first (the bottom of the
  causal triangle) from an atomic counter; a producer warpgroup keeps Q and a
  3-stage ring of 128-key K/V tiles loaded by TMA (128-byte swizzle,
  mbarrier full/empty pairs); two consumer warpgroups take turns on the
  tensor cores (S = Q·Kᵀ and O += P·V as ``wgmma``, P kept in registers)
  so one's online softmax overlaps the other's products, and mask only the
  tiles that need it. The two scheduling counters are cached per device
  (``_sched``) and are 0 between calls, so calls on one device are ordered
  on one stream, as the engine issues them.
- ``fma`` (f32, and bf16 with hd 256): FMA units over shared-memory tiles;
  ``wgmma`` on f32 inputs would round them to TF32 and miss the f32
  tolerance.

Both skip every key tile above the causal diagonal or left of the window
(``prefill_tile_plan`` gives the schedule).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — there is no fallback and no switch that turns it off.
"""

from __future__ import annotations

import ctypes

import torch

from quorum_tpu_torch.ops import cuda_build
from quorum_tpu_torch.ops.attention import prefill_attention

SUPPORTED_HEAD_DIMS = (64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"fma": 0, "wgmma": 1}  # the C entry point's route argument
# (query rows, keys) per tile of each route: csrc BM / BN.
TILES = {"wgmma": (128, 128), "fma": (64, 64)}
_SCHED: dict[torch.device, torch.Tensor] = {}


def prefill_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel variant a CUDA call of this dtype and head dim takes; the
    wrapper passes it to the C entry point."""
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {SUPPORTED_HEAD_DIMS}")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype in _DTYPE_CODES:
        return "fma"
    raise ValueError(f"dtype {dtype}: need one of float32, bfloat16")


def prefill_tile_plan(seq_len: int, length: int, window: int = 0,
                      route: str = "wgmma") -> list[tuple[int, int, int]]:
    """One row's schedule, as the kernel walks it: for each query tile
    starting at ``q0``, the key range ``[k_lo, k_hi)`` (whole key tiles) it
    loads. A tile that starts at or past the length gets an empty range: it
    writes zeros and loads nothing."""
    bm, bn = TILES[route]
    n = min(max(length, 0), seq_len)
    plan = []
    for q0 in range(0, seq_len, bm):
        if q0 >= n:
            plan.append((q0, 0, 0))
            continue
        k_end = min(q0 + bm, n)
        k_begin = max(0, q0 - window + 1) if window > 0 else 0
        plan.append((q0, k_begin // bn * bn, -(-k_end // bn) * bn))
    return plan


def _sched(device) -> torch.Tensor:
    """The wgmma route's two scheduling counters on ``device``: zeroed once,
    reset to 0 by the kernel at the end of every launch."""
    buf = _SCHED.get(device)
    if buf is None:
        buf = _SCHED[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return buf


def _entry():
    lib = cuda_build.load("flash_prefill")
    fn = lib.qt_flash_prefill
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, lengths, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,S,hd], k/v [B,K,S,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} differ")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not lengths and t.data_ptr() % 16:  # lengths: plain int32 loads
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B]={b}, got {tuple(lengths.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    return prefill_route(q.dtype, hd)


def flash_prefill_attention(
    q: torch.Tensor,        # [B, H, S, hd]
    k: torch.Tensor,        # [B, K, S, hd]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid prompt lengths
    window: int = 0,
) -> torch.Tensor:
    """Causal, length-masked prefill attention. Returns [B, H, S, hd]; on the
    card, rows at or past ``lengths[b]`` are 0."""
    if q.device.type == "cpu":
        return prefill_attention(q, k, v, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_attention runs on cuda or cpu, not {q.device}")
    lengths = lengths.to(torch.int32).contiguous()
    route = _check(q, k, v, lengths, window)
    b, h, s, hd = q.shape
    fn = _entry()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             _sched(q.device).data_ptr(), b, h, k.shape[1], s, hd, window, hd ** -0.5,
             _DTYPE_CODES[q.dtype], _ROUTE_CODES[route],
             torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_prefill")
    flash_prefill_attention.launches += 1
    flash_prefill_attention.launches_by_route[route] += 1
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention.launches_by_route = {"wgmma": 0, "fma": 0}
