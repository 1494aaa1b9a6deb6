"""The port's pipeline-staged serving (``parallel/pipeline.py``) on two gloo
CPU stages, float32, llama-tiny at 4 layers: this process is stage 0 and
``tests/torch_pipeline_worker.py`` stage 1.

The contract is ``tests/test_pp_decode.py``'s (:205-228): the staged chunk
and loop equal the unstaged ``decode_chunk`` and ``decode_loop`` bit for bit
on every output — tokens, valid flags and counts, the finish state, the
lengths, the sampler carry, the aux leaves (a per-row logprob and a
per-step count) and both cache halves — here the port's staged functions
against the port's own unstaged ones (the JAX staged path cannot run on
jax 0.9.0: its ``shard_map(check_rep=)`` is gone). The rows cover a
mid-chunk EOS, a budget that runs out and a row dead at entry. The staged
admission's logits and cache writes equal ``transformer.prefill``'s.
"""

import datetime
import multiprocessing

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_pipeline_worker
from quorum_tpu_torch.models.init import init_params, init_params_shard
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import (decode_chunk, decode_loop, init_cache,
                                                 prefill)
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.parallel.comm import join
from quorum_tpu_torch.parallel.pipeline import (row_groups, staged_decode_chunk,
                                                staged_decode_loop, staged_prefill)

SPEC = resolve_spec("llama-tiny", {"dtype": "float32", "n_kv_heads": "4", "n_layers": "4",
                                   "max_seq": "64"})
SEED, ROWS, BUCKET = 0, 4, 16
PROMPTS = [[5, 9], [7, 3, 8], [4], [6, 2, 9, 11]]


def _sampler(noise):
    """An engine-shaped sampler: penalties on the carried counts, token-
    indexed per-row noise (the engine's ``_noise_ring`` rule), a per-row
    logprob and a per-step count of live rows."""
    r = noise.shape[0]
    rows = torch.arange(ROWS)

    def sample_fn(logits, lv, carry):
        ntok, counts = carry
        adj = logits - 0.1 * counts
        nxt = torch.argmax(adj / 0.8 + noise[ntok % r, rows], dim=-1)
        counts = counts.scatter_add(1, nxt[:, None], lv[:, None].to(counts.dtype))
        ntok = ntok + lv.to(ntok.dtype)
        s_lp = torch.log_softmax(adj, dim=-1).gather(1, nxt[:, None])[:, 0]
        return nxt, (ntok, counts), (s_lp, lv.to(torch.int32).sum())

    return sample_fn


def _state(eos3: int = -1) -> dict:
    return dict(token=torch.tensor([3, 4, 5, 6]), lengths=torch.tensor(
        [len(p) for p in PROMPTS], dtype=torch.int32), live=torch.tensor([True, True, False, True]),
        budget=torch.tensor([8, 3, 5, 8], dtype=torch.int32),
        eos=torch.tensor([-1, -1, -1, eos3], dtype=torch.int32),
        carry=(torch.zeros(ROWS, dtype=torch.long),
               torch.zeros((ROWS, SPEC.vocab_size), dtype=torch.int32)))


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat(v)]


def _equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(fa, fb))


@pytest.fixture(scope="module")
def stages():
    """Stage 0 here, stage 1 in a spawned process; ``run(op)`` sends it an
    op, ``get()`` reads its answer."""
    torch.set_num_threads(1)
    mesh = make_mesh(MeshConfig(pp=2), ["cpu", "cpu"])
    store = dist.TCPStore("127.0.0.1", 0, 2, True, timeout=datetime.timedelta(seconds=60),
                          wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    ops, out = ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=torch_pipeline_worker.stage,
                       args=(store.port, SPEC, SEED, ROWS, ops, out), daemon=True)
    proc.start()
    rmesh = join(mesh, 0, store)
    yield rmesh, ops, out
    ops.put(("stop",))
    rmesh.shutdown(10.0)
    proc.join(30)
    if proc.is_alive():
        proc.kill()


def test_row_groups_refuse_in_jax_words():
    assert row_groups(2, 4) == 2
    with pytest.raises(ValueError, match=r"staged decode needs the slot batch \(3\) divisible "
                                         r"by pp=2"):
        row_groups(2, 3)


@torch.no_grad()
def test_staged_prefill_chunk_and_loop_bit_for_bit(stages):
    rmesh, ops, out = stages
    full = init_params(SPEC, SEED, "cpu")
    mine = init_params_shard(SPEC, SEED, rmesh, 0, "cpu")
    assert mine["blocks"]["wq"].shape[0] == SPEC.n_layers // 2 and mine["tok_emb"] is not None
    noise = -torch.log(-torch.log(torch.rand((3, ROWS, SPEC.vocab_size),
                                             generator=torch.Generator().manual_seed(4))))
    sample_fn = _sampler(noise)

    # Reference: the unstaged functions over the whole model, to find an
    # EOS that row 3 samples mid-chunk.
    def reference(eos3):
        ck, cv = init_cache(SPEC, ROWS, device="cpu")
        logits = []
        for slot, p in enumerate(PROMPTS):
            tokens = torch.tensor([p + [0] * (BUCKET - len(p))])
            lg, _, _ = prefill(full, SPEC, tokens, torch.tensor([len(p)], dtype=torch.int32),
                               ck, cv, slot=slot)
            logits.append(lg)
        st = _state(eos3)
        chunk = decode_chunk(full, SPEC, 4, st["token"], st["lengths"], st["live"],
                             st["budget"], st["eos"], ck, cv, sample_fn, st["carry"])
        _, _, _, lv, bud, _, _, lens, carry, _ = chunk
        loop = decode_loop(full, SPEC, 2, 3, chunk[0][:, -1], lens, lv, bud, st["eos"], ck, cv,
                           sample_fn, carry)
        return logits, chunk, loop, (ck.clone(), cv.clone())

    first = reference(-1)[1][0]
    eos3 = int(first[3, 1])
    logits_ref, chunk_ref, loop_ref, cache_ref = reference(eos3)
    assert int(chunk_ref[2][3]) == 2  # row 3 stops at its EOS, its 2nd token

    # Staged: this stage's layers here, the other half in stage 1.
    ck, cv = init_cache(SPEC, ROWS, device="cpu", layers=SPEC.n_layers // 2)
    for slot, p in enumerate(PROMPTS):
        ops.put(("prefill", len(p), BUCKET, slot))
        tokens = torch.tensor([p + [0] * (BUCKET - len(p))])
        lg, _, _ = staged_prefill(mine, SPEC, tokens, torch.tensor([len(p)], dtype=torch.int32),
                                  ck, cv, slot, rmesh)
        assert torch.equal(lg, logits_ref[slot]), slot
    st = _state(eos3)
    ops.put(("decode", 4, 1))
    chunk = staged_decode_chunk(mine, SPEC, rmesh, 4, st["token"], st["lengths"], st["live"],
                                st["budget"], st["eos"], ck, cv, sample_fn, st["carry"])
    assert out.get(timeout=60) == 2 * 4  # stage 1's group steps: pp × steps
    for i, (a, b) in enumerate(zip(chunk, chunk_ref)):
        if i not in (5, 6):  # the caches are compared below, by stage
            assert _equal(a, b), i
    _, _, _, lv, bud, _, _, lens, carry, _ = chunk
    ops.put(("decode", 2, 3))
    loop = staged_decode_loop(mine, SPEC, rmesh, 2, 3, chunk[0][:, -1], lens, lv, bud,
                              st["eos"], ck, cv, sample_fn, carry)
    assert out.get(timeout=60) == 3 * 2 * 2
    for i, (a, b) in enumerate(zip(loop, loop_ref)):
        if i not in (5, 6):
            assert _equal(a, b), i
    ops.put(("cache",))
    ck1, cv1 = out.get(timeout=60)
    half = SPEC.n_layers // 2
    assert torch.equal(ck, cache_ref[0][:half]) and torch.equal(cv, cache_ref[1][:half])
    assert np.array_equal(ck1, cache_ref[0][half:].numpy())
    assert np.array_equal(cv1, cache_ref[1][half:].numpy())
