"""The port's mesh layout and sharding rules (``quorum_tpu_torch/parallel/
mesh.py``, ``sharding.py``) against the JAX package's on its 8-device CPU
mesh, and each rank's cut of the weights (``models/convert.shard_params``,
``models/init.init_params_shard``). No ranks are spawned here.

- every leaf's partition spec of llama-tiny, gpt2-tiny and gemma-tiny
  equals JAX's ``param_partition_specs`` (tuples of mesh-axis names);
- the ranks' shards put back together give the whole tree, and the seeded
  shard init is the cut of the seeded full init, bit for bit;
- each rank's shard is cut exactly along the dims JAX's specs map to tp;
- the (dp, pp, sp, tp) rank layout is JAX's device layout, and the
  sequence-parallel head check is JAX's where the heads divide;
- the refusals: dp and pp by name, NCCL over ranks sharing a card or over
  several ranks naming backend="gloo", fewer devices than ranks naming
  both counts.
"""

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel.mesh import make_mesh as jax_make_mesh
from quorum_tpu.parallel.sharding import param_partition_specs as jax_param_specs
from quorum_tpu.parallel.ulysses import ulysses_supported as jax_ulysses_supported
from quorum_tpu_torch.backends import cuda_backend
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.init import init_params, init_params_shard
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.parallel import (MeshConfig, make_mesh, param_partition_specs,
                                       rank_heads, rank_kv_heads, rank_kv_index,
                                       ulysses_supported)
from quorum_tpu_torch.parallel.sharding import PARAM_LOGICAL_AXES

MODELS = ["llama-tiny", "gpt2-tiny", "gemma-tiny"]
OPTS = {"dtype": "float32"}


def _cpu_mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _jax_specs(model: str, replicate_kv: bool = False) -> dict:
    jparams = jax_init_params(jax_resolve_spec(model, OPTS), seed=0)
    return dict(_leaves(jax.tree.map(
        lambda s: s, jax_param_specs(jparams, replicate_kv_heads=replicate_kv),
        is_leaf=lambda x: x is None or not isinstance(x, dict))))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("replicate_kv", [False, True])
def test_partition_specs_equal_jax(model, replicate_kv):
    want = _jax_specs(model, replicate_kv)
    params = init_params(resolve_spec(model, OPTS), 0, "cpu")
    got = dict(_leaves(param_partition_specs(params, replicate_kv_heads=replicate_kv)))
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert got[name] == (None if spec is None else tuple(spec)), name


def _tp_axis(name: str):
    axes = PARAM_LOGICAL_AXES.get(name.split("/")[-1], ())
    for i, a in enumerate(axes):
        if a in ("heads", "kv_heads", "ff", "vocab"):
            return i, a
    return None, None


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_put_back_together_give_the_whole(model, tp):
    """The JAX package's weights, cut for each rank and put back together:
    concatenated along the tp-cut axis (the kv heads a rank shares with
    another once), every leaf is the whole; the seeded shard init is the
    cut of the seeded init bit for bit."""
    spec = resolve_spec(model, OPTS)
    jparams = jax.tree.map(np.asarray, jax_init_params(jax_resolve_spec(model, OPTS), seed=1))
    full = params_from_numpy(jparams, device="cpu")
    mesh = _cpu_mesh(tp=tp)
    shards = [shard_params(full, mesh, r, spec) for r in range(tp)]
    for name, whole in _leaves(full):
        if whole is None:
            continue
        parts = [dict(_leaves(s))[name] for s in shards]
        dim, axis = _tp_axis(name)
        if dim is None or parts[0].shape == whole.shape:
            for p in parts:
                assert torch.equal(p, whole), name
            continue
        if axis == "kv_heads":
            ranges = sorted({rank_kv_heads(spec.n_heads, spec.n_kv_heads, tp, r)
                             for r in range(tp)})
            firsts = [next(r for r in range(tp)
                           if rank_kv_heads(spec.n_heads, spec.n_kv_heads, tp, r) == rg)
                      for rg in ranges]
            parts = [parts[r] for r in firsts]
        assert torch.equal(torch.cat(parts, dim=dim), whole), name
    seeded = init_params(spec, 5, "cpu")
    for r in range(tp):
        a = dict(_leaves(init_params_shard(spec, 5, mesh, r, "cpu")))
        b = dict(_leaves(shard_params(seeded, mesh, r, spec)))
        assert sorted(a) == sorted(b)
        for name in a:
            assert (a[name] is None and b[name] is None) or torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("cfg", [dict(tp=4), dict(sp=2, tp=2), dict(sp=4), dict(sp=2, tp=4)])
def test_rank_layout_is_the_jax_device_layout(cfg):
    """Rank r sits where JAX's make_mesh puts device r: (dp, pp, sp, tp),
    tp innermost; each axis subgroup is JAX's row of the device array."""
    jmesh = jax_make_mesh(JaxMeshConfig(**cfg))
    mesh = _cpu_mesh(**cfg)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for coords in np.ndindex(*ids.shape):
        r = int(ids[coords])
        assert tuple(mesh.coords(r).values()) == coords
        assert mesh.axis_ranks(r, "tp") == [int(x) for x in ids[coords[:3]]]
        assert mesh.axis_ranks(r, "sp") == [int(x) for x in ids[coords[0], coords[1], :,
                                                                  coords[3]]]


@pytest.mark.parametrize("model,tp", [("llama-tiny", 2), ("llama-tiny", 4), ("gpt2-tiny", 2),
                                      ("gpt2-tiny", 4), ("gemma-tiny", 4)])
def test_shards_are_cut_where_jax_specs_name_tp(model, tp):
    """A rank's leaf is narrower than the whole exactly along the dims JAX's
    spec maps to tp, wherever tp divides the dim (the kv heads included:
    where tp does not divide their count, the rank keeps the ones its
    query heads read); every other dim is whole."""
    want = _jax_specs(model)
    spec = resolve_spec(model, OPTS)
    full = init_params(spec, 0, "cpu")
    mesh = _cpu_mesh(tp=tp)
    for r in range(tp):
        shard = dict(_leaves(shard_params(full, mesh, r, spec)))
        for name, whole in _leaves(full):
            if whole is None:
                continue
            jspec = tuple(want[name]) + (None,) * (whole.dim() - len(want[name]))
            for d in range(whole.dim()):
                cut = shard[name].shape[d] < whole.shape[d]
                assert cut == (jspec[d] == "tp" and whole.shape[d] % tp == 0), (name, d)


@pytest.mark.parametrize("h,n_kv,cfg", [
    (8, 4, dict(sp=2, tp=2)), (8, 4, dict(sp=4)), (8, 2, dict(sp=2, tp=4)),
    (4, 4, dict(sp=8)), (8, 8, dict(sp=2)), (6, 3, dict(sp=2, tp=2)),
])
def test_ulysses_supported_equals_jax_where_heads_divide(h, n_kv, cfg):
    assert ulysses_supported(h, n_kv, _cpu_mesh(**cfg)) == jax_ulysses_supported(
        h, n_kv, jax_make_mesh(JaxMeshConfig(**cfg)))


def test_ulysses_splits_few_kv_heads_where_jax_falls_back():
    """MQA on tp=2 × sp=2: JAX replicates the heads and cannot split one kv
    head (it falls back to dense attention); each port rank's query heads
    get the one kv head they read."""
    assert not jax_ulysses_supported(4, 1, jax_make_mesh(JaxMeshConfig(sp=2, tp=2)))
    assert ulysses_supported(4, 1, _cpu_mesh(sp=2, tp=2))


def test_rank_heads_and_kv_heads():
    assert [rank_heads(8, 4, r) for r in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    # tp divides K: K/tp each; else the groups a rank's heads fall in.
    assert [rank_kv_heads(8, 4, 2, r) for r in range(2)] == [(0, 2), (2, 4)]
    assert [rank_kv_heads(4, 2, 4, r) for r in range(4)] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    # tp does not divide H: every head on every rank (the JAX package's
    # _fit_spec replicates a dim the mesh does not divide).
    assert [rank_heads(6, 4, r) for r in range(4)] == [(0, 6)] * 4
    # Query-head groups tp cuts unevenly (12 heads over 3 kv heads on tp=2):
    # the kv projections whole on every rank, each rank's cache the kv heads
    # its own query heads read, in their order.
    assert [rank_kv_heads(12, 3, 2, r) for r in range(2)] == [(0, 3), (0, 3)]
    assert [rank_kv_index(12, 3, 2, r) for r in range(2)] == [[0, 0, 1], [1, 2, 2]]


def test_mesh_refusals_name_the_reason(monkeypatch):
    # pp meshes are laid out like any other (the engine refuses pp beside
    # dp or tp, in the JAX engine's words).
    assert make_mesh(MeshConfig(pp=2), ["cpu"] * 2).shape["pp"] == 2
    assert make_mesh(MeshConfig(dp=2, pp=2), ["cpu"] * 4).coords(3) == {
        "dp": 1, "pp": 1, "sp": 0, "tp": 0}
    assert make_mesh(MeshConfig(dp=2), ["cpu"] * 2).shape["dp"] == 2
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        make_mesh(MeshConfig(tp=4), ["cpu"] * 2)
    with pytest.raises(ValueError, match="CPU ranks run over gloo"):
        make_mesh(MeshConfig(tp=2), ["cpu"] * 2, backend="nccl")
    assert make_mesh(MeshConfig(sp=2), ["cpu"] * 2).backend == "gloo"
    # Without a card, a CUDA mesh is an error, never the CPU.
    with pytest.raises(RuntimeError, match="need 1 CUDA devices, this machine has 0"):
        make_mesh(MeshConfig(tp=2), ["cuda:0", "cuda:0"], backend="gloo")
    # One card, two NCCL ranks on it: refused, naming the way out.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r'one card .*backend="gloo"'):
        make_mesh(MeshConfig(tp=2), ["cuda:0", "cuda:0"])
    mesh = make_mesh(MeshConfig(tp=2), ["cuda:0", "cuda:0"], backend="gloo")
    assert mesh.backend == "gloo" and len(mesh.devices) == 2
    assert make_mesh(MeshConfig(), ["cuda:0"]).backend == "nccl"
    # cuda://…?tp=2 on a one-card machine: both counts named.
    with pytest.raises(ValueError, match=r"tp=2 x sp=1 needs 2 CUDA devices .* has 1"):
        cuda_backend._url_mesh({"tp": "2"})
    # Several NCCL ranks on cards of their own are a mesh; NCCL stays
    # refused where ranks share a card, naming gloo.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for devices in (["cuda:0", "cuda:1"], ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]):
        cfg = MeshConfig(tp=2, sp=len(devices) // 2)
        assert make_mesh(cfg, devices).backend == "nccl"
        with pytest.raises(ValueError, match=r'one card .*backend="gloo"'):
            make_mesh(cfg, ["cuda:0"] * len(devices))
        assert make_mesh(cfg, devices, backend="gloo").devices == tuple(map(torch.device,
                                                                            devices))
    assert cuda_backend._url_mesh({"tp": "2", "sp": "2"}).backend == "nccl"
    assert cuda_backend._url_mesh({"dp": "2", "tp": "2"}).shape == {"dp": 2, "pp": 1, "sp": 1,
                                                                      "tp": 2}
    assert cuda_backend._url_mesh({"tp": "1", "sp": "1"}) is None
    assert cuda_backend._url_mesh({"tp": "2", "sp": "2", "device": "cpu"}).size == 4
