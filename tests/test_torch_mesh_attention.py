"""Ring attention and Ulysses over gloo ranks on the CPU
(``quorum_tpu_torch/parallel/ring_attention.py``, ``ulysses.py``) against the
JAX package's on its 8-device CPU mesh, float32, within 1e-5 on the rows
below each length (padded rows mean nothing on either side). The cases
follow the JAX package's tests/test_ring_attention.py and test_ulysses.py
on 2 and 4 ranks: lengths, GQA grouped inside the ring, tp-cut heads, kv
heads tp does not divide (each port rank keeps the kv head its query heads
read), a window under Ulysses, heads that do not split refused. Then the
sequence-parallel model forward (``forward_logits_sp``) against JAX's.

Each rank gets its sequence block of its tp rank's heads; the test puts
the blocks back together. One group of ranks per mesh (module-scoped).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.models.transformer import forward_logits_sp as jax_forward_logits_sp
from quorum_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quorum_tpu.parallel.ring_attention import ring_prefill_attention as jax_ring
from quorum_tpu.parallel.ulysses import ulysses_prefill_attention as jax_ulysses
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.models.transformer import _sp_blocks
from quorum_tpu_torch.parallel import (MeshConfig, RankGroup, make_mesh, rank_heads,
                                       rank_kv_heads)
from quorum_tpu_torch.parallel.ranks import to_host

RING = "quorum_tpu_torch.parallel.ring_attention:ring_prefill_attention"
ULYSSES = "quorum_tpu_torch.parallel.ulysses:ulysses_prefill_attention"
FORWARD = "quorum_tpu_torch.models.transformer:forward_logits_sp"
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process too: the ranks share the host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

MESHES = {"sp2": dict(sp=2), "sp4": dict(sp=4), "sp2_tp2": dict(sp=2, tp=2)}


@pytest.fixture(scope="module")
def groups():
    made = {}

    def get(name):
        if name not in made:
            cfg = MeshConfig(**MESHES[name])
            grp = RankGroup(make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0))
            grp.start()
            made[name] = grp
        return made[name]

    yield get
    for grp in made.values():
        grp.stop()


def _inputs(seed, b, h, n_kv, s, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, s, hd)).astype(np.float32)
                 for n in (h, n_kv, n_kv))


def _run(grp, fn, q, k, v, lengths, **kw):
    """``fn`` on every rank over its block; the blocks put back together."""
    mesh = grp.mesh
    h, n_kv, s = q.shape[1], k.shape[1], q.shape[2]
    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    blk = s // sp
    args = []
    for r in range(mesh.size):
        c = mesh.coords(r)
        qs, ks = rank_heads(h, tp, c["tp"]), rank_kv_heads(h, n_kv, tp, c["tp"])
        seq = slice(c["sp"] * blk, (c["sp"] + 1) * blk)
        args.append((q[:, qs[0]:qs[1], seq], k[:, ks[0]:ks[1], seq], v[:, ks[0]:ks[1], seq],
                     np.asarray(lengths, np.int32)))
    outs = grp.run(fn, args, [kw] * mesh.size)
    got = np.zeros_like(q)
    for r, o in enumerate(outs):
        c = mesh.coords(r)
        qs = rank_heads(h, tp, c["tp"])
        got[:, qs[0]:qs[1], c["sp"] * blk:(c["sp"] + 1) * blk] = o
    return got


def _close(got, want, lengths):
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=TOL, atol=TOL)


RING_CASES = [
    # (mesh, b, h, n_kv, s, hd, lengths): the JAX tests' shapes on <= 4 ranks
    ("sp4", 2, 2, 2, 64, 16, [30, 55]),        # lengths (and test_ring_sp4_matches_full)
    ("sp4", 2, 8, 2, 64, 16, [64, 40]),        # GQA grouped inside the ring
    ("sp2_tp2", 2, 8, 2, 32, 16, [32, 32]),    # GQA with tp-cut heads
    ("sp2_tp2", 1, 4, 1, 32, 16, [32]),        # kv heads tp does not divide
    ("sp2", 2, 4, 2, 32, 16, [32, 9]),         # two ranks
]


@pytest.mark.parametrize("case", RING_CASES, ids=lambda c: f"{c[0]}-h{c[2]}k{c[3]}s{c[4]}")
def test_ring_matches_jax(groups, case):
    name, b, h, n_kv, s, hd, lengths = case
    q, k, v = _inputs(0, b, h, n_kv, s, hd)
    jmesh = jax_make_mesh(JaxMeshConfig(**MESHES[name]))
    want = np.asarray(jax.jit(jax_ring, static_argnums=(4,))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths, jnp.int32), jmesh))
    _close(_run(groups(name), RING, q, k, v, lengths), want, lengths)


ULYSSES_CASES = [
    # (mesh, h, n_kv, window): the JAX tests' cases on <= 4 ranks
    ("sp2_tp2", 8, 4, 0),
    ("sp2_tp2", 8, 4, 16),   # a window: the ring refuses it
    ("sp2_tp2", 4, 1, 0),    # kv heads tp does not divide (JAX: dense fallback)
    ("sp2", 8, 2, 0),
]


@pytest.mark.parametrize("case", ULYSSES_CASES, ids=lambda c: f"{c[0]}-h{c[1]}k{c[2]}w{c[3]}")
def test_ulysses_matches_jax(groups, case):
    name, h, n_kv, window = case
    b, s, hd, lengths = 2, 64, 16, [64, 37]
    q, k, v = _inputs(1, b, h, n_kv, s, hd)
    jmesh = jax_make_mesh(JaxMeshConfig(**MESHES[name]))
    want = np.asarray(jax.jit(jax_ulysses, static_argnums=(4,), static_argnames=("window",))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths, jnp.int32), jmesh,
        window=window))
    _close(_run(groups(name), ULYSSES, q, k, v, lengths, window=window), want, lengths)


def test_indivisible_shapes(groups):
    """Heads that do not split over sp are refused (JAX falls back to the
    dense path, which the engine refuses at construction); a sequence sp
    does not divide runs whole on every rank."""
    q, k, v = _inputs(2, 1, 4, 4, 32, 16)
    grp = groups("sp4")
    with pytest.raises(Exception, match="do not split over sp=4"):
        grp.run(ULYSSES, [(q[:, :2, :8], k[:, :2, :8], v[:, :2, :8],
                           np.asarray([32], np.int32))] * 4)
    grp.stop()  # the ranks raised: this group is spent
    spec = resolve_spec("llama-tiny", {"dtype": "float32"})
    two = groups("sp2").rank_mesh
    assert _sp_blocks(two, 32, spec, "ulysses") == 2
    assert _sp_blocks(two, 24, spec, "ring") == 2
    assert _sp_blocks(two, 25, spec, "ring") == 1
    with pytest.raises(ValueError, match="sliding_window specs cannot use ring-attention"):
        _sp_blocks(two, 32, resolve_spec("llama-tiny", {"sliding_window": "16"}), "ring")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_forward_logits_sp_matches_jax(groups, impl):
    """The whole model forward on sp=2 × tp=2 (each rank its sequence block
    and its shard of the weights), as JAX's test_forward_logits_sp_matches_dense
    runs it (llama-tiny, max_seq 64, f32, lengths 32 and 20)."""
    opts = {"max_seq": "64", "dtype": "float32", "n_kv_heads": "4"}
    jspec = jax_resolve_spec("llama-tiny", opts)
    jparams = jax_init_params(jspec, seed=0)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 32), 1, jspec.vocab_size))
    lengths = np.asarray([32, 20], np.int32)
    jmesh = jax_make_mesh(JaxMeshConfig(dp=2, sp=2, tp=2))
    want = np.asarray(jax.jit(lambda p, t, l: jax_forward_logits_sp(
        p, jspec, t, l, jmesh, sp_impl=impl))(jparams, tokens, lengths))
    spec = resolve_spec("llama-tiny", opts)
    full = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    grp = groups("sp2_tp2")
    args = [(to_host(shard_params(full, grp.mesh, r, spec)), spec, tokens, lengths)
            for r in range(4)]
    outs = grp.run(FORWARD, args, [{"sp_impl": impl}] * 4)
    for o in outs:  # every rank returns the whole sequence's logits
        _close(o, want, lengths)
