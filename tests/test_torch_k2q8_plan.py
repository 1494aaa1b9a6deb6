"""K2q8's split plan on the host (``ops/flash_decode_q8``), on the CPU.

The kernel (``csrc/flash_decode_q8.cu``) runs one cluster of C blocks per
(row, kv head); each block sizes its chunk of the row's live range from the
row's length on the device, and ``q8_split_plan`` mirrors that rule. These
tests hold the mirror to a direct count: every live key of
``[max(n − W, 0), n)`` is covered by exactly one block and nothing outside
it is covered, over lengths at and around the chunk granule and the cache's
end, windows of 0, 1 and the whole cache, caches up to 131 072 keys and
clusters of 8 and 16. The cluster size comes from the shapes alone, and the
on-chip logit store plus its spill always hold a block's longest chunk.
"""

import inspect

import numpy as np
import pytest

from quorum_tpu_torch.ops import flash_decode_q8 as fq
from quorum_tpu_torch.ops.flash_decode import N_SMS, SUPPORTED_HEAD_DIMS

CACHES = (256, 8192, 131072)


def _lengths(t):
    return sorted({0, 1, 63, 64, 65, t - 1, t})


@pytest.mark.parametrize("cluster", fq.CLUSTER_SIZES)
@pytest.mark.parametrize("window_of", ["none", "one", "whole"])
@pytest.mark.parametrize("t,length", [(t, n) for t in CACHES for n in _lengths(t)])
def test_plan_covers_each_live_key_once(t, length, window_of, cluster):
    window = {"none": 0, "one": 1, "whole": t}[window_of]
    plan = fq.q8_split_plan(length, t, cluster, window)
    assert len(plan) == cluster
    counts = np.zeros(t + 1, dtype=np.int64)
    for begin, end in plan:
        assert begin <= end  # an idle block: (begin, begin), covering nothing
        if end > begin:
            assert 0 <= begin and end <= t
            counts[begin:end] += 1
    lo = max(length - window, 0) if window else 0
    want = np.zeros(t + 1, dtype=np.int64)
    want[lo:length] = 1
    assert np.array_equal(counts, want)
    # Active blocks come first; every chunk but the last is whole and a
    # multiple of the granule; block 0 is always active.
    sizes = [end - begin for begin, end in plan]
    active = [s for s in sizes if s]
    assert sizes[:len(active)] == active
    chunk = plan[1][0] - plan[0][0]
    assert chunk % fq.MIN_CHUNK == 0 and chunk >= fq.MIN_CHUNK
    assert all(s == chunk for s in active[:-1])
    assert plan[0][0] == lo


@pytest.mark.parametrize("cluster", fq.CLUSTER_SIZES)
@pytest.mark.parametrize("t", CACHES)
def test_longest_chunk_fits_the_logit_store(t, cluster):
    for hd in SUPPORTED_HEAD_DIMS:
        for group in range(1, 9):
            stride = fq.logit_stride(group, hd)
            assert stride % 32 == 8 and stride >= 8
            assert (group + 1) * stride * 4 <= fq.logit_bytes(hd)
            longest = max(end - begin for n in (t - 1, t)
                          for begin, end in fq.q8_split_plan(n, t, cluster))
            assert longest <= stride + fq.spill_keys(t, cluster, group, hd)


def test_cluster_size_comes_from_shapes_alone():
    assert list(inspect.signature(fq.q8_cluster_size).parameters) == [
        "batch", "n_kv", "cache_len"]
    for batch in (1, 2, 4, 8, 12, 32):
        for n_kv in (1, 2, 4, 8):
            for t in (128, 8192, 8193, 32768, 131072):
                c = fq.q8_cluster_size(batch, n_kv, t)
                assert c in fq.CLUSTER_SIZES
                assert c == (16 if batch * n_kv * 16 <= 4 * N_SMS and t <= 8192 else 8)
    # the kernels line's shapes: 4 slots of llama-3-8b's 8 kv heads
    assert fq.q8_cluster_size(4, 8, 8192) == 16
    assert fq.q8_cluster_size(4, 8, 32768) == 8
