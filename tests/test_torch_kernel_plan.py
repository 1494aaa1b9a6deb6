"""The Python-side plans of the port's attention kernels against brute force.

The CUDA kernels cannot run here, but the schedules they follow are mirrored
in their wrappers as pure Python: K1's live query-tile / key-tile ranges
(``prefill_tile_plan``, with the zero-rows-past-length rule), K2's per-block
split chunks (``decode_split_plan``) and the route chooser
(``prefill_route``). These tests hold each plan against a brute-force
enumeration over random lengths, windows and sequence lengths, and hold the
Python constants against the CUDA sources they mirror.
"""

import re

import numpy as np
import pytest
import torch

from quorum_tpu_torch.ops import cuda_build
from quorum_tpu_torch.ops import flash_attention as fa
from quorum_tpu_torch.ops import flash_decode as fd


def _needed_keys(row, length, window):
    """Keys row ``row`` attends: causal, below the length, inside the window."""
    lo = max(0, row - window + 1) if window > 0 else 0
    return range(lo, min(row, length - 1) + 1)


def _random_cases(seed, n, max_s):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        s = int(rng.integers(1, max_s + 1))
        length = int(rng.integers(0, s + 1))
        window = int(rng.choice([0, 0, int(rng.integers(1, s + 1))]))
        cases.append((s, length, window))
    return cases


# ---- K1: live query tiles and key tiles -------------------------------------------

@pytest.mark.parametrize("route", ["wgmma", "fma"])
@pytest.mark.parametrize("seed", range(4))
def test_prefill_tile_plan_covers_exactly_the_live_work(route, seed):
    bm, bn = fa.TILES[route]
    for s, length, window in _random_cases(seed, 40, 700):
        plan = fa.prefill_tile_plan(s, length, window, route=route)
        assert [q0 for q0, _, _ in plan] == list(range(0, s, bm))  # every row in one tile
        for q0, k_lo, k_hi in plan:
            rows = range(q0, min(q0 + bm, s))
            if q0 >= length:  # zero tile: no loads, every row past the length
                assert (k_lo, k_hi) == (0, 0)
                continue
            assert k_lo % bn == 0 and k_hi % bn == 0 and k_lo < k_hi
            needed = set()
            for r in rows:
                needed.update(_needed_keys(r, length, window))
            assert needed, (s, length, window, q0)  # a live tile has a live key
            # every needed key is loaded, and the first and last loaded key
            # tiles each hold one: no tile is loaded for nothing at either end
            assert k_lo <= min(needed) < k_lo + bn
            assert k_hi - bn <= max(needed) < k_hi
            assert k_hi <= -(-length // bn) * bn  # never past the length's tile


@pytest.mark.parametrize("s,length,want_live", [
    (512, 317, 3), (2048, 1217, 10), (4096, 3017, 24), (4096, 4096, 32), (128, 0, 0),
])
def test_prefill_padding_tiles_do_no_work(s, length, want_live):
    """The serve phase's prompt buckets: tiles past the length are zero tiles."""
    plan = fa.prefill_tile_plan(s, length, route="wgmma")
    assert sum(1 for _, lo, hi in plan if hi > lo) == want_live


def test_prefill_pairs_loaded_shrink_with_the_padding_skip():
    """At S=2048, length 1217 the plan loads no more key tiles than the
    causal triangle of the live rows needs (the padding rows cost none)."""
    plan = fa.prefill_tile_plan(2048, 1217, route="wgmma")
    loaded = sum((hi - lo) // 128 for _, lo, hi in plan)
    assert loaded == sum(range(1, 11))  # tiles 0..9, each loads tiles 0..i


# ---- K2: split chunks ----------------------------------------------------------------

@pytest.mark.parametrize("n_splits", [1, 3, 16, 32])
@pytest.mark.parametrize("seed", range(3))
def test_decode_split_plan_covers_each_live_key_once(n_splits, seed):
    for t, length, window in _random_cases(100 + seed, 60, 9000):
        plan = fd.decode_split_plan(length, t, n_splits, window)
        assert len(plan) == n_splits
        n = min(max(length, 0), t)
        live = list(range(max(n - window, 0) if window > 0 else 0, n))
        covered = [c for lo, hi in plan for c in range(lo, hi)]
        assert covered == live  # in order, once each
        assert all(hi <= n for lo, hi in plan if hi > lo)  # no chunk reaches past the length
        active = [hi > lo for lo, hi in plan]
        assert active[0] or not live
        assert active == sorted(active, reverse=True)  # active blocks come first
        sizes = [hi - lo for lo, hi in plan if hi > lo]
        assert all(sz % fd.MIN_CHUNK == 0 for sz in sizes[:-1])
        assert all(sz >= fd.MIN_CHUNK for sz in sizes[:-1])


def test_decode_split_plan_short_rows_use_one_block():
    for length in (1, 2, 63, 64):
        plan = fd.decode_split_plan(length, 8192, 16)
        assert sum(hi > lo for lo, hi in plan) == 1


def test_decode_split_plan_long_row_uses_every_block():
    plan = fd.decode_split_plan(8191, 8192, 16)
    assert all(hi > lo for lo, hi in plan)
    assert max(hi - lo for lo, hi in plan) == 512


@pytest.mark.parametrize("b,n_kv", [(1, 1), (1, 8), (4, 8), (8, 8), (64, 8), (2, 32)])
def test_decode_n_splits_fills_the_card(b, n_kv):
    ns = fd.decode_n_splits(b, n_kv)
    assert 16 <= ns <= fd.MAX_SPLITS
    assert b * n_kv * ns >= 2 * fd.N_SMS or ns == fd.MAX_SPLITS


# ---- the route chooser -----------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 256, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 256, "fma"),
])
def test_prefill_route(dtype, hd, route):
    assert fa.prefill_route(dtype, hd) == route


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 128), (torch.float64, 64),
                                      (torch.bfloat16, 96), (torch.float32, 32)])
def test_prefill_route_refuses_what_no_route_takes(dtype, hd):
    with pytest.raises(ValueError):
        fa.prefill_route(dtype, hd)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "fma"),
                                         (torch.float16, None), (torch.float64, None)])
def test_decode_route(dtype, route):
    if route is None:
        with pytest.raises(ValueError):
            fd.decode_route(dtype)
    else:
        assert fd.decode_route(dtype) == route


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 64), (torch.bfloat16, 96)])
def test_wrapper_checks_refuse_before_any_launch(dtype, hd):
    """The argument checks a CUDA call runs first raise for a dtype or head
    dim that no route takes (run here on CPU tensors of the same shapes)."""
    q = torch.zeros(1, 4, 8, hd, dtype=dtype)
    kv = torch.zeros(1, 2, 8, hd, dtype=dtype)
    lengths = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim|dtype"):
        fa._check(q, kv, kv, lengths, 0)
    with pytest.raises(ValueError, match="head_dim|dtype"):
        fd._check(q[:, :, :1], kv, kv, lengths, 0)


def _offset_view(shape, dtype, offset):
    """A contiguous tensor whose data starts ``offset`` elements into its
    storage (so its address may break 16-byte alignment)."""
    n = 1
    for d in shape:
        n *= d
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("kernel", ["prefill", "decode"])
def test_wrapper_checks_take_lengths_at_any_offset(kernel):
    """``lengths`` is read with plain int32 loads: a view at an odd word
    offset passes the checks (only what the copies read must be aligned)."""
    q = torch.zeros(2, 4, 8 if kernel == "prefill" else 1, 64, dtype=torch.bfloat16)
    kv = torch.zeros(2, 2, 8, 64, dtype=torch.bfloat16)
    lengths = _offset_view((2,), torch.int32, 1)
    assert lengths.data_ptr() % 16
    if kernel == "prefill":
        assert fa._check(q, kv, kv, lengths, 0) == "wgmma"
    else:
        fd._check(q, kv, kv, lengths, 0)


@pytest.mark.parametrize("kernel", ["prefill", "decode"])
@pytest.mark.parametrize("which", ["q", "k"])
def test_wrapper_checks_refuse_misaligned_inputs(kernel, which):
    s = 8 if kernel == "prefill" else 1
    q = torch.zeros(2, 4, s, 64, dtype=torch.bfloat16)
    kv = torch.zeros(2, 2, 8, 64, dtype=torch.bfloat16)
    if which == "q":
        q = _offset_view(q.shape, q.dtype, 1)
    else:
        kv = _offset_view(kv.shape, kv.dtype, 1)
    lengths = torch.tensor([8, 8], dtype=torch.int32)
    check = fa._check if kernel == "prefill" else fd._check
    with pytest.raises(ValueError, match="16-byte aligned"):
        check(q, kv, kv, lengths, 0)


# ---- Python mirrors of the CUDA constants ---------------------------------------------

def _constexpr(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_python_plans_mirror_the_cuda_sources():
    pre = (cuda_build.CSRC / "flash_prefill.cu").read_text()
    wg = pre[pre.index("namespace wgmma_route"):]
    fm = pre[pre.index("namespace fma_route"):pre.index("namespace wgmma_route")]
    assert fa.TILES["wgmma"] == (_constexpr(wg, "BM"), _constexpr(wg, "BN"))
    assert fa.TILES["fma"] == (_constexpr(fm, "BM"), _constexpr(fm, "BN"))
    dec = (cuda_build.CSRC / "flash_decode.cu").read_text()
    assert fd.MIN_CHUNK == _constexpr(dec, "MIN_CHUNK")
    assert fd.MAX_SPLITS == _constexpr(dec, "MAX_SPLITS")
    assert fd.MAX_GROUP == _constexpr(dec, "GMAX")
    assert set(cuda_build.KERNEL_SOURCES) == {p.stem for p in cuda_build.CSRC.glob("*.cu")}
