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
Σ live · K · (2·hd + 8). One launch per call: a grid (C, K, B) of
thread-block clusters, one cluster of C blocks per (row, kv head), C chosen
from the shapes (:func:`q8_cluster_size`); each block takes its chunk of
the row's live range (:func:`q8_split_plan`), streams its K and then its V
tiles through a TMA ring, runs q·Kᵀ and p·V on the int8 tensor cores
(``mma.sync`` m16n8k32), keeps its logits and V's scales in shared memory
(past :func:`logit_stride` keys they spill to a scratch, :func:`spill_keys`),
and merges the row's softmax partials with its peers through distributed
shared memory between two cluster barriers, so every block quantizes the
probabilities with the row's one scale. No tile gets a scale of its own:
that would be another function.

Scratch: only the logits spill, sized from the shapes and cached per
device, stream and shape under a lock. ``launches`` counts calls that
launched (one kernel per call), exactly under concurrent callers; a call
made while its thread captures a CUDA graph counts as captured and is added
per replay (``ops/launches.py``).

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
from quorum_tpu_torch.ops.attention import (_int_dot, decode_attention_q8, q8_probabilities,
                                            refuse_autograd)
from quorum_tpu_torch.ops.flash_decode import _DTYPE_CODES, MAX_GROUP, N_SMS, SUPPORTED_HEAD_DIMS

MIN_CHUNK = 128  # keys: the least work one block takes, one ring stage (csrc MIN_CHUNK)
CLUSTER_SIZES = (8, 16)  # portable, and the H100's non-portable maximum
_SCRATCH: dict[tuple, torch.Tensor] = {}
_LOCK = threading.Lock()
# The kernel's probabilities p·vs/ps agree with the plain version's within
# a few f32 ulps (its softmax merges split partials in another order, with
# one more exp per merge); this relative margin covers them ten times over.
PROB_REL = 1e-5


def q8_cluster_size(batch: int, n_kv: int, cache_len: int) -> int:
    """Blocks per (row, kv head), from the shapes alone — never the
    lengths. 16 while the B·K clusters of 16 come to at most four blocks
    per SM (what the card holds at hd ≤ 128) and a cache of at most 8 192
    keys bounds a block's chunk to 512: a cluster's blocks past its row's
    live range exit at once, so short rows free their slots for the long
    rows' clusters. Else 8: past that, rows long enough to fill every
    block of 16 would leave a tail of clusters the card cannot place."""
    return 16 if batch * n_kv * 16 <= 4 * N_SMS and cache_len <= 8192 else 8


def q8_split_plan(length: int, cache_len: int, cluster: int,
                  window: int = 0) -> list[tuple[int, int]]:
    """The key range [begin, end) each of a row's ``cluster`` blocks covers,
    as ``csrc/flash_decode_q8.cu`` split_range computes it on the device;
    an idle block gets ``(begin, begin)``. The live range is
    [max(n − W, 0), n) with n = clamp(length, 0, cache_len); each chunk is
    ceil(live / cluster) rounded up to a multiple of ``MIN_CHUNK`` (at
    least ``MIN_CHUNK``). Block 0 is always active: for a row with no live
    key it writes zeros."""
    n = min(max(length, 0), cache_len)
    lo = max(n - window, 0) if window > 0 else 0
    live = n - lo
    chunk = -(-live // cluster)
    chunk = max(MIN_CHUNK, -(-chunk // MIN_CHUNK) * MIN_CHUNK)
    n_act = max(1, -(-live // chunk))
    plan = []
    for r in range(cluster):
        begin = lo + r * chunk
        plan.append((begin, min(begin + chunk, n)) if r < n_act else (begin, begin))
    return plan


def logit_bytes(head_dim: int) -> int:
    """Shared memory a block keeps its logits and V's scales in (csrc
    ``Cfg<HD>::LOGIT``): 12 KB at hd ≤ 128, where four blocks share an SM,
    28 KB at hd 256."""
    return (28 if head_dim > 128 else 12) * 1024


def logit_stride(group: int, head_dim: int) -> int:
    """Keys a block keeps on chip per row of its logit store — one row per
    query head and one of V's scales (csrc logit_stride), ≡ 8 mod 32."""
    return (logit_bytes(head_dim) // 4 // (group + 1) - 8) // 32 * 32 + 8


def spill_keys(cache_len: int, cluster: int, group: int, head_dim: int) -> int:
    """Keys per row a block's logit store may spill past
    :func:`logit_stride`: the longest chunk the cache allows (every key
    live) beyond it."""
    begin, end = q8_split_plan(cache_len, cache_len, cluster)[0]
    return max(0, end - begin - logit_stride(group, head_dim))


def _lib():
    lib = cuda_build.load("flash_decode_q8")
    fn = lib.qt_flash_decode_q8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        occ = lib.qt_flash_decode_q8_occupancy
        occ.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        occ.restype = ctypes.c_int
    return lib


def occupancy(hd: int, dtype: torch.dtype, cluster: int) -> dict:
    """How many clusters of ``cluster`` blocks the card holds at once
    (``cudaOccupancyMaxActiveClusters``) and a block's dynamic shared
    memory, for the kernel of this head dim and q dtype."""
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = _lib().qt_flash_decode_q8_occupancy(hd, _DTYPE_CODES[dtype], cluster,
                                              ctypes.byref(n), ctypes.byref(smem))
    cuda_build.check(err, "flash_decode_q8 occupancy")
    return {"cluster": cluster, "max_active_clusters": n.value, "smem_bytes": smem.value}


def _scratch(device, stream, b, n_kv, cluster, group, keys):
    """The logit store's spill [B, K, C, G + 1, keys] f32 of one shape on one stream
    of one device (``stream``: its handle), made once and reused by every
    later call on that stream."""
    key = (device, stream, b, n_kv, cluster, group, keys)
    buf = _SCRATCH.get(key)
    if buf is None:
        with _LOCK:
            buf = _SCRATCH.get(key)
            if buf is None:
                buf = _SCRATCH[key] = torch.empty((b * n_kv * cluster * (group + 1) * keys,),
                                                  dtype=torch.float32, device=device)
    return buf


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
    if any(x.data_ptr() % 16 for x in (k8, v8, ks, vs)):
        raise ValueError("k8, v8 and their scales must be 16-byte aligned (TMA copies)")
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
    """Decode attention over the int8 cache. Returns [B, H, 1, hd] in q's
    dtype. Refuses grad-requiring inputs under grad mode."""
    refuse_autograd("flash_decode_q8_attention", q, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_q8(q, k8, k_scale, v8, v_scale, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_q8_attention runs on cuda or cpu, not {q.device}")
    lengths = lengths.to(torch.int32).contiguous()
    _check(q, k8, k_scale, v8, v_scale, lengths, window)
    b, h, _, hd = q.shape
    n_kv, t = k8.shape[1], k8.shape[2]
    group = h // n_kv
    cluster = q8_cluster_size(b, n_kv, t)
    n_spill = spill_keys(t, cluster, group, hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    spill = (_scratch(q.device, stream, b, n_kv, cluster, group, n_spill).data_ptr()
             if n_spill else None)
    out = torch.empty_like(q)
    err = _lib().qt_flash_decode_q8(
        q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(), v_scale.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), spill, b, h, n_kv, t, hd, window, cluster,
        n_spill, hd ** -0.5, _DTYPE_CODES[q.dtype], stream)
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
