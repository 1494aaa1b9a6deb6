"""The port's host prefix store (``prefix_store=host``), its wire format and
the cache↔host chunk movement, against the JAX package's.

- ``PrefixStore`` and ``prefix_wire``: one random sequence of inserts and
  lookups on both stores (the port's holding torch tensors, JAX's numpy
  arrays of the same bytes) gives the same returns, coverage, stats and
  eviction order; the exported chains serialize to the SAME bytes, and
  each side parses the other's.
- ``kv_transfer``: ``slice_rows`` equals JAX's on the same dense cache
  (bf16 and int8), and write → slice is the identity, dense and paged.
- The engine scenarios of tests/test_prefix_store.py on ``device="cpu"``:
  a conversation whose only slot was reclaimed restores its history from
  the store and streams exactly what a cold prefill streams (greedy and
  sampled, bf16 and int8, dense and paged); only the tail past a
  slot-resident overlap moves; the byte budget holds; snapshots are
  incremental; export → import seeds another engine; the refusals and the
  URL knobs say what ``tpu://`` says.

llama-tiny (max_seq 128), float32 unless stated, greedy unless stated.
"""

import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.cache import kv_transfer as jkv
from quorum_tpu.cache import prefix_wire as jwire
from quorum_tpu.cache.prefix_store import PrefixStore as JaxStore
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.cache import kv_transfer, prefix_wire
from quorum_tpu_torch.cache.paging import init_paged_cache
from quorum_tpu_torch.cache.prefix_store import PrefixStore
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import init_cache
from quorum_tpu_torch.ops.sampling import SamplerConfig

SPEC = resolve_spec("llama-tiny", {"dtype": "float32", "max_seq": "128"})
GREEDY = SamplerConfig(temperature=0.0)
SAMPLED = SamplerConfig(temperature=0.9, top_p=0.95)
CHUNK = 16


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompt(n, base=3):
    return [(base + i * 7) % (SPEC.vocab_size - 1) + 1 for i in range(n)]


def _arrays(rng, kind):
    """One chunk's leaves as (torch tensors, numpy arrays) of equal bytes."""
    if kind == "int8":
        q8 = rng.integers(-127, 128, (2, 2, 4, 8), dtype=np.int8)
        sc = rng.random((2, 2, 4)).astype(np.float32)
        return [torch.from_numpy(q8.copy()), torch.from_numpy(sc.copy())], [q8, sc]
    x = rng.standard_normal((2, 2, 4, 8)).astype(ml_dtypes.bfloat16)
    return [torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)], [x]


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_store_and_wire_match_jax(kind):
    """Same inserts, same answers; the same serialized bytes; each side
    parses the other's blob into the same chains."""
    rng = np.random.default_rng(0)
    pick = random.Random(1)
    chunk = 4
    per_chunk = sum(a.nbytes for a in _arrays(rng, kind)[1])
    port, ref = PrefixStore(chunk, 5 * per_chunk), JaxStore(chunk, 5 * per_chunk)
    vocab = [1, 2, 3]
    for _ in range(40):
        toks = [pick.choice(vocab) for _ in range(pick.randrange(4, 20))]
        have = port.covered(toks)
        assert have == ref.covered(toks)
        n_new = (len(toks) - have) // chunk
        pairs = [_arrays(rng, kind) for _ in range(n_new)]
        assert port.insert(toks, have, [p for p, _ in pairs]) == \
            ref.insert(toks, have, [j for _, j in pairs])
        probe = [pick.choice(vocab) for _ in range(pick.randrange(1, 20))]
        (n_p, pay_p), (n_j, pay_j) = port.longest_match(probe), ref.longest_match(probe)
        assert n_p == n_j and len(pay_p) == len(pay_j)
        for cp, cj in zip(pay_p, pay_j):
            for a, b in zip(cp, cj):
                assert prefix_wire._raw(a) == np.ascontiguousarray(b).tobytes()
        assert port.stats() == ref.stats()
    chains_p, chains_j = port.export_chains(), ref.export_chains()
    assert [t for t, _ in chains_p] == [t for t, _ in chains_j]
    blob_p = prefix_wire.serialize_chains(chains_p, chunk)
    blob_j = jwire.serialize_chains(chains_j, chunk)
    assert blob_p == blob_j
    assert prefix_wire.stats(blob_p) == jwire.stats(blob_j)
    c_p, parsed_p = prefix_wire.parse(blob_j)
    c_j, parsed_j = jwire.parse(blob_p)
    assert c_p == c_j == chunk
    for a, b in zip(parsed_p, parsed_j):
        assert a.tokens == b.tokens and a.nbytes == b.nbytes
        for cp, cj in zip(a.payloads, b.payloads):
            for x, y in zip(cp, cj):
                assert x.dtype == getattr(torch, y.dtype.name)
                assert prefix_wire._raw(x) == y.tobytes()
    with pytest.raises(prefix_wire.WireError, match="bad magic"):
        prefix_wire.parse(b"nope")


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kv_transfer_dense_matches_jax_and_round_trips(kv_quant):
    """slice_rows of the dense [L, S, K, T, hd] cache equals JAX's; a write
    of that chunk into another row slices back unchanged."""
    spec = resolve_spec("llama-tiny", {"dtype": "bfloat16", "max_seq": "64"})
    ck, cv = init_cache(spec, 3, kv_quant=kv_quant)
    gen = torch.Generator().manual_seed(0)
    for side in (ck, cv):
        for leaf in (side if kv_quant else (side,)):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    got = kv_transfer.slice_rows((ck, cv), 1, 16, 32)

    def jx(t):
        return jnp.asarray(_np(t))

    jcache = tuple((jx(s[0]), jx(s[1])) if kv_quant else jx(s) for s in (ck, cv))
    want = jkv.slice_rows(jcache, 1, 16, 32, stacked=False, n_slots=3)
    got_leaves = kv_transfer.chunk_leaves(got)
    want_leaves = [x for side in want for x in (side if kv_quant else (side,))]
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(_np(g), np.float32), np.asarray(w, np.float32))
    kv_transfer.write_rows((ck, cv), got, 2, 32)
    back = kv_transfer.chunk_leaves(kv_transfer.slice_rows((ck, cv), 2, 32, 32))
    for a, b in zip(back, got_leaves):
        assert torch.equal(a, b)
    host = kv_transfer.fetch_to_host(got)
    assert all(h.device.type == "cpu" and torch.equal(h, g) for h, g in zip(host, got_leaves))


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kv_transfer_paged_round_trip(kv_quant):
    """A chunk written through a row's pages slices back unchanged, at an
    unaligned start; rows of another member stay untouched."""
    spec = resolve_spec("llama-tiny", {"dtype": "float32", "max_seq": "64"})
    ck, cv = init_paged_cache(spec, 2, 8, 16, kv_quant=kv_quant, members=2)
    ck.table[1] = torch.tensor([3, 1, 4, 2], dtype=torch.int32)      # member 0, slot 1
    ck.table[3] = ck.table[1] + 9                                     # member 1, slot 1
    src = kv_transfer.slice_rows(init_cache(spec, 1, kv_quant=kv_quant), 0, 0, 40)
    gen = torch.Generator().manual_seed(3)
    for leaf in kv_transfer.chunk_leaves(src):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
    kv_transfer.write_rows((ck, cv), src, 3, 5)
    back = kv_transfer.slice_rows((ck, cv), 3, 5, 40)
    for a, b in zip(kv_transfer.chunk_leaves(back), kv_transfer.chunk_leaves(src)):
        assert torch.equal(a, b)
    other = kv_transfer.slice_rows((ck, cv), 1, 0, 64)
    assert not any(x.any() for x in kv_transfer.chunk_leaves(other))


def _store_engine(**kw):
    return InferenceEngine(SPEC, device="cpu", decode_chunk=4, prefill_chunk=CHUNK,
                           n_slots=1, prefix_store="host", **kw)


def _cold(**kw):
    kw.pop("kv_pages", None)
    return InferenceEngine(SPEC, device="cpu", decode_chunk=4, prefill_chunk=CHUNK,
                           n_slots=1, **kw)


@pytest.mark.parametrize("sampler,kw", [
    (GREEDY, {}), (SAMPLED, {}), (GREEDY, {"kv_quant": "int8"}),
    (GREEDY, {"kv_pages": True}), (SAMPLED, {"kv_pages": True, "kv_quant": "int8"}),
], ids=["greedy", "sampled", "int8", "paged", "paged-int8-sampled"])
def test_churn_restore_matches_cold_prefill(sampler, kw):
    """The conversation's only slot is reclaimed by another request; the
    follow-up turn restores its history from the store, prefills only the
    tail and streams exactly what a cold full prefill streams."""
    eng, ref = _store_engine(**kw), _cold(**kw)
    try:
        conv = _prompt(24, base=9)
        gen1 = eng.generate(conv, max_new_tokens=6, sampler=sampler, seed=3).token_ids
        eng.drain_prefix_store()
        eng.generate(_prompt(30, base=600), max_new_tokens=4, sampler=GREEDY)
        turn2 = conv + gen1 + _prompt(5, base=42)
        got = eng.generate(turn2, max_new_tokens=8, sampler=sampler, seed=4).token_ids
        m = eng.metrics()
        assert m["prefix_store_hits_total"] == 1
        assert m["prefix_store_restored_tokens_total"] >= CHUNK
        assert m["prefix_store_restore_bytes_total"] > 0
        assert got == ref.generate(turn2, max_new_tokens=8, sampler=sampler, seed=4).token_ids
    finally:
        eng.shutdown()
        ref.shutdown()


@pytest.mark.parametrize("kv_pages", [False, True])
def test_restore_transfers_only_tail_past_slot_resident_overlap(kv_pages):
    shared = _prompt(16, base=3)
    conv = shared + _prompt(16, base=101)
    eng, ref = _store_engine(kv_pages=kv_pages), _cold()
    try:
        gen1 = eng.generate(conv, max_new_tokens=6, sampler=GREEDY, seed=11).token_ids
        eng.drain_prefix_store()
        eng.generate(shared + _prompt(20, base=202), max_new_tokens=4, sampler=GREEDY, seed=12)
        eng.drain_prefix_store()
        saved0 = eng.prefix_tokens_saved
        turn2 = conv + gen1 + _prompt(5, base=77)
        got = eng.generate(turn2, max_new_tokens=6, sampler=GREEDY, seed=13).token_ids
        assert eng.prefix_store_hits == 1
        # 32 matched, 16 already slot-resident: only the 16-token tail moves
        assert eng.prefix_store_tokens_restored == CHUNK
        assert eng.prefix_tokens_saved - saved0 == CHUNK
        assert got == ref.generate(turn2, max_new_tokens=6, sampler=GREEDY,
                                   seed=13).token_ids
    finally:
        eng.shutdown()
        ref.shutdown()


def test_int8_store_holds_half_the_bytes_or_less():
    held = {}
    for kvq in (None, "int8"):
        eng = _store_engine(kv_quant=kvq)
        try:
            eng.generate(_prompt(24, base=21), max_new_tokens=6, sampler=GREEDY)
            eng.drain_prefix_store()
            held[kvq] = eng.prefix_store.bytes_held
        finally:
            eng.shutdown()
    assert 0 < held["int8"] < held[None] / 2


def test_byte_budget_and_incremental_snapshots():
    eng = _store_engine(prefix_store_bytes=9000)  # two 16-token f32 chunks (4 096 B each)
    try:
        eng.generate(_prompt(40, base=5), max_new_tokens=4, sampler=GREEDY)
        eng.generate(_prompt(40, base=900), max_new_tokens=4, sampler=GREEDY)
        eng.drain_prefix_store()
        s = eng.prefix_store.stats()
        assert s["bytes_held"] <= 9000 and s["evictions_total"] >= 1
        assert eng.metrics()["prefix_store_evictions_total"] == s["evictions_total"]
    finally:
        eng.shutdown()
    eng = _store_engine()
    try:
        conv = _prompt(24, base=8)
        gen1 = eng.generate(conv, max_new_tokens=6, sampler=GREEDY, seed=7).token_ids
        eng.drain_prefix_store()
        inserts1 = eng.prefix_store.n_inserts
        eng.generate(conv + gen1 + _prompt(20, base=90), max_new_tokens=6, sampler=GREEDY)
        eng.drain_prefix_store()
        s = eng.prefix_store.stats()
        assert s["inserts_total"] > inserts1 and s["inserts_total"] == s["entries"]
    finally:
        eng.shutdown()


def test_export_import_seeds_another_engine():
    """A chain exported from one engine restores on another with the same
    weights and streams what a cold prefill streams; a blob of another
    layout is refused before anything is stored."""
    src, dst, ref = _store_engine(), _store_engine(kv_pages=True), _cold()
    try:
        conv = _prompt(40, base=4)
        src.generate(conv, max_new_tokens=4, sampler=GREEDY)
        src.drain_prefix_store()
        blob = src.export_prefix_chunks()
        got = dst.import_prefix_chunks(blob)
        assert got["chains_imported"] == 1 and got["tokens_imported"] == 32
        turn2 = conv + _prompt(3, base=11)
        assert dst.generate(turn2, max_new_tokens=6, sampler=GREEDY).token_ids == \
            ref.generate(turn2, max_new_tokens=6, sampler=GREEDY).token_ids
        assert dst.prefix_store_hits == 1
    finally:
        for e in (src, dst, ref):
            e.shutdown()
    q8 = _store_engine(kv_quant="int8")
    try:
        with pytest.raises(ValueError, match="this cache has 4 leaves"):
            q8.import_prefix_chunks(blob)
        assert q8.prefix_store.n_entries == 0
    finally:
        q8.shutdown()


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_in_jax_words():
    from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
    from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec

    jspec = jax_resolve_spec("llama-tiny", {"max_seq": "128"})
    for kw in ({"members": 2}, {"ensemble": 2}, {"prefix_store": "disk"},
               {"prefill_chunk": 0}, {"prefix_store_chunk": 256}):
        kw = {"prefill_chunk": CHUNK, "prefix_store": "host", **kw}
        assert _refusal(lambda: InferenceEngine(SPEC, device="cpu", **kw)) == \
            _refusal(lambda: JaxEngine(jspec, **kw)), kw


@pytest.mark.parametrize("tail", [
    "&members=2&member=0&prefix_store=host", "&prefix_store=disk", "&prefix_store_bytes=1g",
    "&prefix_store=host&prefix_store_bytes=lots", "&prefix_store_chunk=16",
])
def test_store_url_misuse_refused_in_tpu_words(tail):
    with pytest.raises(ValueError) as want:
        TpuBackend.from_spec(JaxBackendSpec(name="X", url=f"tpu://llama-tiny?{tail[1:]}",
                                            model="m"))
    with pytest.raises(ValueError) as got:
        CudaBackend.from_spec(BackendSpec(
            name="X", url=f"cuda://llama-tiny?device=cpu{tail}", model="m"))
    assert str(got.value) == str(want.value)


def test_store_knobs_parse_through_backend_url():
    try:
        b = CudaBackend.from_spec(BackendSpec(
            name="S", model="m",
            url=("cuda://llama-tiny?device=cpu&dtype=float32&max_seq=64&seed=31"
                 "&prefix_store=host&prefix_store_bytes=2m&prefix_store_chunk=16")))
        store = b.engine.prefix_store
        assert store is not None and store.max_bytes == 2 << 20 and store.chunk_tokens == 16
        m = b.engine.metrics()
        assert m["prefix_store_bytes"] == 0 and m["prefix_store_entries"] == 0
    finally:
        shutdown_all_engines()
