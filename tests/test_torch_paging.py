"""The port's paged KV ops and page allocator against the JAX package's
(``quorum_tpu_torch/cache/paging.py`` vs ``quorum_tpu/cache/paging.py``).

- Every device op on the same pools and tables: bf16, f32 and int8 pools,
  per layer and (the wire ops, the page copy) on the full stack, single
  and member-stacked. Indexing ops match exactly; the int8 writes
  quantize in f32 with the same formula and match exactly too. The port's
  pool has one more physical page, the trash page its dropped writes land
  on, so pools compare on the JAX pool's pages; member-stacked pools
  compare by reshaping the port's flat page axis.
- The zero sinks stay zero under dropped and dead writes.
- ``PageAllocator``: one random sequence of alloc, assign, extend, share,
  adopt, release, touch, drop, evict and reclaim queries on both
  allocators gives the same returns, chains, refcounts and free counts.
- ``validate_page_config``: the same messages.
- The ``kv_pages=0`` key pin: a dense engine dispatches only the dense
  program keys; a paged one only ``("paged", …, history)`` keys.

llama-tiny widths (K=2, hd=32), page size 8, max_seq 32.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from quorum_tpu.cache import paging as jp
from quorum_tpu_torch.cache import paging as tp
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig

L, K, HD, PS, MP, S, N_PAGES = 2, 2, 32, 8, 4, 3, 13
MAX_SEQ = PS * MP


def _pool(rng, dtype, n_pages=N_PAGES, stacked=False):
    """(port pool, JAX pool): random pages with zero sinks, ``[L, P, K, ps,
    hd]`` (JAX stacked: ``[M, L, ...]``, M=2). The port's pool flattens the
    members into the page axis and appends the trash page."""
    shape = ((2,) if stacked else ()) + (L, n_pages + 1, K, PS, HD)
    if dtype == "int8":
        q8 = rng.integers(-127, 128, shape, dtype=np.int8)
        sc = rng.random(shape[:-1]).astype(np.float32)
        q8[..., 0, :, :, :] = 0
        sc[..., 0, :, :] = 0
        return ((_port_pool(q8, stacked), _port_pool(sc, stacked)),
                (jnp.asarray(q8), jnp.asarray(sc)))
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0, :, :, :] = 0
    x = x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    return _port_pool(x, stacked), jnp.asarray(x)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _port_pool(x, stacked):
    t = _to_torch(x)
    if stacked:  # [M, L, P, ...] → [L, M·P, ...]
        t = t.transpose(0, 1).reshape(t.shape[1], -1, *t.shape[3:])
    return torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)


def _table(rng, rows=S, n_pages=N_PAGES, full=False):
    """Distinct pages per row; unless ``full``, some rows short
    (sink-padded). Writes use full chains: an engine reserves every page a
    row can write before it writes."""
    perm = rng.permutation(np.arange(1, n_pages + 1))
    tab = np.zeros((rows, MP), np.int32)
    k = 0
    for r in range(rows):
        n = MP if full or not r else int(rng.integers(1, MP + 1))
        n = min(n, n_pages - k)
        tab[r, :n] = perm[k:k + n]
        k += n
    return tab


def _same_pool(port, jax_pool):
    """A per-layer port pool against JAX's, on JAX's pages (the port's has
    the trash page too)."""
    if isinstance(port, tuple):
        for a, b in zip(port, jax_pool):
            _same_pool(a, b)
        return
    np.testing.assert_array_equal(np.asarray(_to_np(port[:N_PAGES + 1]), np.float32),
                                  np.asarray(jax_pool, np.float32))


def _layer0(port_pool, jax_pool, tab):
    pp = tuple(p[0] for p in port_pool) if isinstance(port_pool, tuple) else port_pool[0]
    jpl = tuple(p[0] for p in jax_pool) if isinstance(jax_pool, tuple) else jax_pool[0]
    return tp.PagedKV(pp, torch.from_numpy(tab)), jp.PagedKV(jpl, jnp.asarray(tab))


DTYPES = ["float32", "bfloat16", "int8"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hist", [4, 8, 16, 32])
def test_page_read_matches_jax(dtype, hist):
    """The gathered window equals JAX's bit for bit (indexing only)."""
    rng = np.random.default_rng(hist)
    port, jax_pool = _pool(rng, dtype)
    tkv, jkv = _layer0(port, jax_pool, _table(rng))
    got, want = tp.page_read(tkv, hist), jp.page_read(jkv, hist)
    for g, w in zip(got if dtype == "int8" else (got,), want if dtype == "int8" else (want,)):
        assert g.is_contiguous()
        np.testing.assert_array_equal(np.asarray(_to_np(g), np.float32),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_page_read_row_matches_jax(dtype):
    """The segment read (dequantized for int8) in f32: exact."""
    rng = np.random.default_rng(7)
    port, jax_pool = _pool(rng, dtype)
    tkv, jkv = _layer0(port, jax_pool, _table(rng))
    for slot in range(S):
        got = tp.page_read_row(tkv, slot, 24, torch.float32)
        want = jp.page_read_row(jkv, slot, 24, jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _value(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_page_write_step_and_multi_match_jax(dtype):
    """Decode and verify writes, with masked rows and positions past
    max_seq dropped; the sinks stay zero."""
    rng = np.random.default_rng(11)
    port, jax_pool = _pool(rng, dtype)
    tkv, jkv = _layer0(port, jax_pool, _table(rng, full=True))
    lengths = np.array([3, MAX_SEQ - 2, 9], np.int32)
    allow = np.array([True, True, False])
    tv, jv = _value(rng, (S, K, 1, HD), dtype)
    tp.page_write_step(tkv, tv, torch.from_numpy(lengths), torch.from_numpy(allow), MAX_SEQ)
    jkv = jp.page_write_step(jkv, jv, jnp.asarray(lengths), jnp.asarray(allow), MAX_SEQ)
    _same_pool(tkv.pool, jkv.pool)
    tv, jv = _value(rng, (S, K, 5, HD), dtype)  # row 1 runs 3 positions past max_seq
    tp.page_write_multi(tkv, tv, torch.from_numpy(lengths), torch.from_numpy(allow), MAX_SEQ)
    jkv = jp.page_write_multi(jkv, jv, jnp.asarray(lengths), jnp.asarray(allow), MAX_SEQ)
    _same_pool(tkv.pool, jkv.pool)
    vals = tkv.pool[0] if dtype == "int8" else tkv.pool
    assert not vals[0].any(), "the zero sink was written"


@pytest.mark.parametrize("dtype", DTYPES)
def test_page_write_seg_and_prefill_match_jax(dtype):
    rng = np.random.default_rng(12)
    port, jax_pool = _pool(rng, dtype)
    tkv, jkv = _layer0(port, jax_pool, _table(rng, full=True))
    for offset, gate in ((8, None), (16, True), (0, False), (24, None)):
        tv, jv = _value(rng, (1, K, 8, HD), dtype)
        tp.page_write_seg(tkv, tv, 1, offset, gate, MAX_SEQ)
        jkv = jp.page_write_seg(jkv, jv, 1, offset,
                                None if gate is None else jnp.asarray(gate), MAX_SEQ)
        _same_pool(tkv.pool, jkv.pool)
    tv, jv = _value(rng, (2, K, 13, HD), dtype)
    tp.page_write_prefill(tkv, tv, 1, None, MAX_SEQ)
    jkv = jp.page_write_prefill(jkv, jv, 1, None, MAX_SEQ)
    _same_pool(tkv.pool, jkv.pool)
    vals = tkv.pool[0] if dtype == "int8" else tkv.pool
    assert not vals[0].any(), "the zero sink was written"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stacked", [False, True])
def test_wire_ops_and_page_copy_match_jax(dtype, stacked):
    """paged_slice_rows / paged_write_rows / paged_copy_page on the full
    stack, single and member-stacked (M=2: the port's flat page axis, its
    table rows offset into each member's pages)."""
    rng = np.random.default_rng(13 + stacked)
    m = 2 if stacked else 1
    port, jax_pool = _pool(rng, dtype, stacked=stacked)
    tab = _table(rng, full=True)
    offs = (np.arange(m) * (N_PAGES + 1)).repeat(S)[:, None]
    ttab = torch.from_numpy((np.tile(tab, (m, 1)) + offs).astype(np.int32))
    jtab = np.broadcast_to(tab, ((m,) if stacked else ()) + (L,) + tab.shape).copy()
    tkv, jkv = tp.PagedKV(port, ttab), jp.PagedKV(jax_pool, jnp.asarray(jtab))
    kw = dict(stacked=True, n_slots=S) if stacked else {}
    for row in range(m * S):
        for start, n in ((0, 5), (3, 20), (11, 21), (24, 8)):
            got = tp.paged_slice_rows(tkv, row, start, n)
            want = jp.paged_slice_rows(jkv, row, start, n, **kw)
            for g, w in zip(got if dtype == "int8" else (got,),
                            want if dtype == "int8" else (want,)):
                np.testing.assert_array_equal(np.asarray(_to_np(g), np.float32),
                                              np.asarray(w, np.float32))
    if dtype == "int8":
        q8 = rng.integers(-127, 128, (L, K, 12, HD), dtype=np.int8)
        sc = rng.random((L, K, 12)).astype(np.float32)
        tchunk, jchunk = (torch.from_numpy(q8), torch.from_numpy(sc)), (q8, sc)
    else:
        tchunk, jchunk = _value(rng, (L, K, 12, HD), dtype)
    row = m * S - 1
    tp.paged_write_rows(tkv, tchunk, row, 6)
    jkv = jp.paged_write_rows(jkv, jchunk, row, 6, **kw)
    tp.paged_copy_page(tkv, int(tab[0, 1]), int(tab[0, 0]), members=m)
    jkv = jp.paged_copy_page(jkv, int(tab[0, 1]), int(tab[0, 0]), stacked=stacked)
    port_pool = tkv.pool if dtype == "int8" else (tkv.pool,)
    jax_pools = jkv.pool if dtype == "int8" else (jkv.pool,)
    for p, j in zip(port_pool, jax_pools):
        j = np.asarray(j, np.float32)
        if stacked:  # [M, L, P, ...] → [L, M·P, ...]
            j = np.swapaxes(j, 0, 1).reshape(L, -1, *j.shape[3:])
        np.testing.assert_array_equal(np.asarray(_to_np(p[:, :-1]), np.float32), j)


def test_init_paged_cache_tables_and_sinks():
    spec = dataclasses.replace(resolve_spec("llama-tiny", {"max_seq": "32"}), n_layers=2)
    ck, cv = tp.init_paged_cache(spec, 3, 5, 8, kv_quant="int8", members=2)
    assert ck.table is cv.table and ck.table.shape == (6, 4)
    assert ck.table[:3].eq(0).all() and ck.table[3:].eq(6).all()  # each member's sink
    assert ck.pool[0].shape == (2, 2 * 6 + 1, spec.n_kv_heads, 8, spec.head_dim)
    assert ck.pool[1].dtype == torch.float32 and ck.is_q8 and ck.page_size == 8


def test_validate_page_config_gives_jax_messages():
    for max_seq, ps in ((128, 24), (96, 64), (128, 0)):
        with pytest.raises(ValueError) as want:
            jp.validate_page_config(max_seq, ps)
        with pytest.raises(ValueError) as got:
            tp.validate_page_config(max_seq, ps)
        assert str(got.value) == str(want.value)
    tp.validate_page_config(128, 32)
    with pytest.raises(ValueError, match="kv_pool_pages=0 must be >= 1"):
        tp.PageAllocator(0, 16)


OPS = st.lists(st.tuples(
    st.sampled_from(["alloc", "assign", "extend", "share", "adopt", "release", "touch",
                     "drop", "evict", "reclaimable", "free"]),
    st.integers(0, 5), st.integers(0, 40)), min_size=1, max_size=60)


@settings(max_examples=60, deadline=None)
@given(OPS)
def test_page_allocator_matches_jax(ops):
    """The same random operation sequence on both allocators: the same
    returns and the same state after every step."""
    a, b = tp.PageAllocator(12, 8), jp.PageAllocator(12, 8)

    def step(alloc, op, row, n):
        if op == "alloc":
            return alloc.alloc(n % 6)
        if op == "assign":
            if row in alloc.chains or not loose_of[id(alloc)]:
                return "skip"
            alloc.assign(row, loose_of[id(alloc)].pop())
            return None
        if op == "extend":
            if row not in alloc.chains or not loose_of[id(alloc)]:
                return "skip"
            alloc.extend(row, loose_of[id(alloc)].pop())
            return None
        if op == "share":
            held = alloc.retained_chain(row)
            return alloc.share(held) if held else "skip"
        if op == "adopt":
            return alloc.adopt(row)
        if op == "release":
            return alloc.release(row, keep_tokens=n)
        if op == "touch":
            return alloc.touch(row)
        if op == "drop":
            return alloc.drop_retained(row)
        if op == "evict":
            return alloc.evict_lru(protect=(row,) if n % 2 else ())
        if op == "reclaimable":
            return alloc.reclaimable_pages(protect=(row,) if n % 2 else ())
        if op == "free":
            if not loose_of[id(alloc)]:
                return "skip"
            alloc.free(loose_of[id(alloc)].pop())
            return None

    loose_of = {id(a): [], id(b): []}  # chains allocated, not yet assigned
    for op, row, n in ops:
        ra, rb = step(a, op, row, n), step(b, op, row, n)
        assert ra == rb, (op, row, n)
        if op in ("alloc", "share", "adopt") and ra not in (None, "skip"):
            loose_of[id(a)].append(ra)
            loose_of[id(b)].append(rb)
        assert (a.refs, a.chains, dict(a.retained), a.free_pages, a.allocated_pages) == \
            (b.refs, b.chains, dict(b.retained), b.free_pages, b.allocated_pages)
        assert list(a.retained) == list(b.retained)  # the LRU order too
        assert a.pages_for(n) == b.pages_for(n)


SPEC = resolve_spec("llama-tiny", {"dtype": "float32", "max_seq": "128", "n_layers": "1"})
GREEDY = SamplerConfig(temperature=0.0)


@pytest.mark.parametrize("kv_pages", [False, True])
def test_dense_keys_unchanged_paged_keys_tagged(kv_pages):
    """The kv_pages=0 pin: a dense engine dispatches the dense keys exactly
    ((steps, chunks, sort, lp), ("dfa", …) and ("verify", g, sort, lp,
    history)); a paged engine's every key is ("paged", *dense key, history)
    for a chunk and ("paged", *verify key) for a verify turn."""
    torch.set_num_threads(1)
    eng = InferenceEngine(SPEC, device="cpu", prefill_chunk=16, spec_decode=4,
                          decode_loop=2, kv_pages=kv_pages)
    try:
        for p in ([5, 6, 7], [7, 8, 9, 10] * 6):
            eng.generate(p, max_new_tokens=12, sampler=GREEDY)
        keys = eng.dispatched_keys
    finally:
        eng.shutdown()
    verify = [k for k in keys if "verify" in k]
    plain = [k for k in keys if "verify" not in k]
    assert verify and plain
    if not kv_pages:
        assert all(len(k) == 4 and all(not isinstance(x, str) for x in k) for k in plain)
        assert all(k[0] == "verify" and len(k) == 5 for k in verify)
        return
    assert all(k[0] == "paged" for k in keys)
    for k in plain:
        assert len(k) == 6 and k[-1] in (16, 32, 64, 128) and k[-1] & (k[-1] - 1) == 0
    for k in verify:
        assert k[1] == "verify" and len(k) == 6
