"""int8 weights and int8 KV on multi-rank engines (``cuda://…?tp=N&dp=N&
quant=int8&kv_quant=int8&device=cpu``: rank 0 here, the other ranks
spawned, gloo groups), llama-tiny and gpt2-tiny in float32, against the
JAX engine on the CPU's fake devices and the port's one-rank engine:

- a rank's int8 leaves (``q8`` and the scales ``qs``) are the cut of the
  whole quantized tree bit for bit, for a random init
  (``init_params_shard(quant=)``), given weights (``shard_params(quant=)``)
  and a checkpoint (``load_hf_checkpoint(quant=, mesh=)``), at tp=2 and
  tp=4, and for a vocabulary tp cuts into pieces that are not multiples of
  8 (gpt2-tiny at 514 rows: each rank's piece padded at its own end);
  the row-parallel leaves' scales are the whole leaf's on every rank; the
  partition specs of a quantized tree are the JAX package's;
- a row-parallel int8 product on tp=2 and tp=4 quantizes each rank's
  piece with the whole row's scale (a max all-reduce) and equals the
  one-rank product exactly (int32 accumulators summed over tp);
- ``quant=int8`` on dp=2 × tp=2 (the JAX package's
  ``test_engine_int8_serves_on_mesh`` set-up) gives the JAX mesh engine's
  and the port's one-rank int8 engine's greedy tokens;
- ``kv_quant=int8`` on dp=2 × tp=4 with 4 kv heads (JAX's
  ``test_kv_quant_engine_on_mesh`` set-up) likewise, and so do the uneven
  cut (12 heads over 3 kv heads on tp=2, each rank's int8 cache at the kv
  heads it selects) and both knobs together; each rank's cache is int8 at
  its own kv heads and its dp group's rows, the cut of the JAX engine's
  (values, scales) sharding (``int8_kv_cache_specs``).

Every comparison is exact: greedy tokens in float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu.parallel import MeshConfig as JaxMeshConfig
from quorum_tpu.parallel import make_mesh as jax_make_mesh
from quorum_tpu_torch.engine.engine import InferenceEngine
from quorum_tpu_torch.models import quant as tq
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint
from quorum_tpu_torch.models.init import init_params, init_params_shard
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.ops.attention import quantize_rows
from quorum_tpu_torch.parallel.ranks import RankGroup
from quorum_tpu_torch.parallel.sharding import (PARAM_LOGICAL_AXES, int8_kv_cache_specs,
                                                rank_cut, rank_kv_index)
from test_torch_mesh_ckpt import _write

OPTS = {"dtype": "float32"}
GREEDY = SamplerConfig(temperature=0.0)
GREEDY_J = JaxSampler(temperature=0.0)
PROMPTS = [[3, 5, 7], [(7 + 5 * i) % 500 for i in range(30)]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh(**axes):
    cfg = MeshConfig(**axes)
    return make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if tq.is_quantized(v):
            yield prefix + k, k, v
        elif isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, k, v


def _cut_of_whole(whole, mesh, rank, spec):
    """The test's own cut of a whole quantized tree: each quantized leaf in
    the JAX layout, q8 cut by the plain leaves' rule and each channel's
    scale taken with its channel (a row-parallel leaf keeps every scale),
    then the rank's piece padded."""
    cut = rank_cut(spec, mesh, rank)
    out = {}
    for path, name, v in _leaves(whole):
        if not tq.is_quantized(v):
            out[path] = cut(name, v)
            continue
        axis = tq.QUANT_REDUCE_AXIS[name]
        j = tq.jax_layout(v, axis)
        q8 = cut(name, j["q8"])
        idx = [torch.arange(n) for n in j["q8"].shape]
        for d, ax in enumerate(PARAM_LOGICAL_AXES[name]):
            # The channels the rank keeps along each non-reduced axis.
            if d != j["q8"].dim() + axis:
                lo = cut(name, torch.arange(j["q8"].shape[d]).reshape(
                    [-1 if i == d else 1 for i in range(j["q8"].dim())]).expand(
                    j["q8"].shape)).reshape(-1)
                idx[d] = torch.unique(lo)
        qs = j["qs"]
        for d, ix in enumerate(idx):
            if qs.shape[d] > 1:
                qs = qs.index_select(d, ix)
        out[path] = tq.port_layout({"q8": q8, "qs": qs}, axis)
    return out


def _assert_rank_is_cut(got, want, what):
    got = dict((p, v) for p, _, v in _leaves(got))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path]
        if isinstance(w, dict):
            for k in ("q8", "qs"):
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), f"{what} {path}.{k}"
            assert g["q8"].shape[-2] % 8 == 0 and not g["q8"][..., w["qs"].shape[-2]:, :].any()
        else:
            assert torch.equal(g, w.contiguous()), f"{what} {path}"


@pytest.mark.parametrize("source,model,tp", [
    ("init", "llama-tiny", 2), ("init", "llama-tiny", 4), ("params", "llama-tiny", 2),
    ("params", "llama-tiny", 4), ("ckpt", "llama-tiny", 2), ("ckpt", "llama-tiny", 4),
    ("init", "gpt2-514", 2), ("params", "gpt2-514", 2),
])
def test_rank_int8_cut_is_the_whole_trees_cut(tmp_path, source, model, tp):
    opts = dict(OPTS, vocab_size="514") if model == "gpt2-514" else OPTS
    spec = resolve_spec(model.replace("-514", "-tiny"), opts)
    mesh = _mesh(tp=tp)
    plain = init_params(spec, 13, "cpu")
    whole = tq.quantize_params(plain)
    if source == "ckpt":
        _write(tmp_path, spec, plain, "llama")
    for r in range(tp):
        if source == "init":
            got = init_params_shard(spec, 13, mesh, r, "cpu", quant="int8")
        elif source == "params":
            got = shard_params(plain, mesh, r, spec, quant="int8")
        else:
            got = load_hf_checkpoint(tmp_path, dtype="float32", device="cpu", quant="int8",
                                     mesh=mesh, rank=r)[1]
        _assert_rank_is_cut(got, _cut_of_whole(whole, mesh, r, spec), f"{source} rank {r}")
        # Row-parallel leaves: each rank holds part of every channel's
        # contraction axis and every channel's whole-leaf scale.
        for name in ("wo", "w_down"):
            assert torch.equal(got["blocks"][name]["qs"], whole["blocks"][name]["qs"])
            assert got["blocks"][name]["q8"].shape[-1] * tp == whole["blocks"][name]["q8"].shape[-1]


@pytest.mark.parametrize("lead_axes", [0, 1])
def test_quantized_partition_specs_equal_jax(lead_axes):
    """``param_partition_specs`` of a quantized tree (member-stacked with
    ``lead_axes=1``) names the JAX package's specs for ``q8`` and ``qs``."""
    from quorum_tpu.models import quant as jq
    from quorum_tpu.parallel.sharding import param_partition_specs as jax_specs
    from quorum_tpu_torch.parallel.sharding import param_partition_specs

    jspec = jax_resolve_spec("mixtral-tiny", OPTS)
    jtree = jq.quantize_params(jax_init_params(jspec, seed=1))
    ttree = tq.quantize_params(init_params(resolve_spec("mixtral-tiny", OPTS), 1, "cpu"))
    want = jax.tree.map(tuple, jax_specs(jtree, lead_axes=lead_axes),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert param_partition_specs(ttree, lead_axes=lead_axes) == want


@pytest.fixture(scope="module")
def tp_groups():
    groups = {}
    def get(tp):
        if tp not in groups:
            groups[tp] = RankGroup(_mesh(tp=tp))
            groups[tp].start()
        return groups[tp]

    yield get
    for g in groups.values():
        g.stop()


@pytest.mark.parametrize("tp", [2, 4])
def test_row_parallel_product_equals_one_rank(tp_groups, tp):
    """x [M, K] against a row-parallel leaf ``w [K, N]`` (K cut over tp):
    each rank's activation scale is the whole row's, and the summed
    product is the one-rank product bit for bit."""
    rng = np.random.default_rng(5)
    m, k, n = 6, 64, 24
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    x[0, :8] *= 40.0  # a row whose amax lives on rank 0 alone
    leaf = tq.quantize_weight(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)), -2)
    one_xs, one_y = tq.row_parallel_qmm(x, leaf)
    per = k // tp
    args = [(x[:, r * per:(r + 1) * per].numpy(),
             {"q8": leaf["q8"][:, r * per:(r + 1) * per].numpy(), "qs": leaf["qs"].numpy()})
            for r in range(tp)]
    outs = tp_groups(tp).run("quorum_tpu_torch.models.quant:row_parallel_qmm", args)
    for r, (xs, y) in enumerate(outs):
        assert np.array_equal(xs, one_xs.numpy()), f"rank {r}'s activation scales"
        assert np.array_equal(y, one_y.numpy()), f"rank {r}'s summed product"
    # A rank's own scales would differ: the cut matters.
    assert not torch.equal(quantize_rows(x[:, per:2 * per])[1], one_xs)


# ---- engines -----------------------------------------------------------------


def _jax_params(jspec, seed):
    return jax.tree.map(np.asarray, jax_init_params(jspec, seed=seed))


def _jax_greedy(jeng, prompts, n):
    return [jeng.generate(p, max_new_tokens=n, sampler=GREEDY_J).token_ids for p in prompts]


def _port(spec, params, axes=None, **knobs):
    kw = dict(decode_chunk=4, n_slots=2, params=params_from_numpy(params, device="cpu"), **knobs)
    if axes is None:
        return InferenceEngine(spec, device="cpu", **kw)
    return InferenceEngine(spec, mesh=_mesh(**axes), **kw)


def _greedy(eng, prompts, n):
    return [eng.generate(p, max_new_tokens=n, sampler=GREEDY).token_ids for p in prompts]


def test_int8_weights_on_dp2_tp2_equal_jax_and_one_rank():
    """JAX's set-up (llama-tiny, max_seq 64, dp=2 × tp=2, decode_chunk 4,
    8 greedy tokens of [3, 5, 7]) on the JAX engine's float32 weights."""
    opts = dict(OPTS, max_seq="64")
    jspec, spec = jax_resolve_spec("llama-tiny", opts), resolve_spec("llama-tiny", opts)
    params = _jax_params(jspec, 0)
    jeng = JaxEngine(jspec, jax_make_mesh(JaxMeshConfig(dp=2, tp=2), jax.devices()[:4]),
                     params=jax.tree.map(jnp.asarray, params), decode_chunk=4, quant="int8")
    try:
        want = _jax_greedy(jeng, PROMPTS, 8)
    finally:
        jeng.shutdown()
    one = _port(spec, params, quant="int8")
    mesh = _port(spec, params, dict(dp=2, tp=2), quant="int8")
    try:
        assert _greedy(one, PROMPTS, 8) == want
        assert _greedy(mesh, PROMPTS, 8) == want
        assert tq.is_quantized(mesh.params["blocks"]["wo"])
        c = mesh.rank_reports()[0]["collectives"]
        assert c["all_reduce_max"] > 0, "the row-parallel amax never crossed tp"
    finally:
        one.shutdown()
        mesh.shutdown()


@pytest.mark.parametrize("case", ["kv_int8_dp2_tp4", "uneven_12h_tp2", "both_dp2_tp2"])
def test_int8_kv_on_meshes_equals_jax_and_one_rank(case):
    """``kv_quant=int8``: JAX's dp=2 × tp=4 set-up (4 kv heads, seed 3,
    [7, 8, 9], 8 greedy tokens) against the JAX mesh engine; the uneven cut
    and both knobs against the JAX single-device engine (JAX's own tests
    hold its mesh engines to it)."""
    extra, axes, knobs = {
        "kv_int8_dp2_tp4": ({"n_kv_heads": "4"}, dict(dp=2, tp=4), dict(kv_quant="int8")),
        "uneven_12h_tp2": ({"n_heads": "12", "n_kv_heads": "3"}, dict(tp=2),
                           dict(kv_quant="int8")),
        "both_dp2_tp2": ({}, dict(dp=2, tp=2), dict(kv_quant="int8", quant="int8")),
    }[case]
    opts = dict(OPTS, **extra)
    jspec, spec = jax_resolve_spec("llama-tiny", opts), resolve_spec("llama-tiny", opts)
    params = _jax_params(jspec, 3)
    jmesh = (jax_make_mesh(JaxMeshConfig(**axes), jax.devices()[:8])
             if case == "kv_int8_dp2_tp4" else None)
    jeng = JaxEngine(jspec, jmesh, params=jax.tree.map(jnp.asarray, params), decode_chunk=4,
                     n_slots=2, **knobs)
    prompts = [[7, 8, 9], PROMPTS[1]]
    try:
        want = _jax_greedy(jeng, prompts, 8)
        if jmesh is not None:  # the (values, scales) specs the JAX engine shards
            assert int8_kv_cache_specs(4, 4, 2, 2) == tuple(
                tuple(sh.spec) for sh in jeng._cache_sh)
    finally:
        jeng.shutdown()
    one = _port(spec, params, **knobs)
    mesh = _port(spec, params, axes, **knobs)
    try:
        assert _greedy(one, prompts, 8) == want
        assert _greedy(mesh, prompts, 8) == want
        tp, dp = axes["tp"], axes.get("dp", 1)
        reports = mesh.rank_reports()
        # Rank 0's entries: one of 4 kv heads at tp=4, one of 2 at tp=2, and
        # on the uneven cut the 3 its 6 query heads read (kv heads 0, 0, 1).
        n_kv = len(rank_kv_index(spec.n_heads, spec.n_kv_heads, tp, 0))
        assert n_kv == {"kv_int8_dp2_tp4": 1, "uneven_12h_tp2": 3, "both_dp2_tp2": 1}[case]
        k8, ks = mesh._ck
        assert k8.dtype == torch.int8 and ks.dtype == torch.float32
        assert k8.shape[1:3] == (2 // dp, n_kv) and ks.shape == k8.shape[:-1]
        assert len(reports) == tp * dp - 1
        assert all(r["launches"]["flash_decode_q8"] == 0 for r in reports)  # plain on the CPU
        want_bytes = spec.n_layers * (2 // dp) * n_kv * spec.max_seq * (spec.head_dim + 4) * 2
        assert all(r["cache_bytes"] == want_bytes for r in reports)
    finally:
        one.shutdown()
        mesh.shutdown()
