"""Local HF checkpoints on multi-rank engines (``cuda://…?ckpt=DIR&tp=…|dp=…|
pp=…``, ``get_engine_from_ckpt(mesh=)``) on gloo CPU ranks, float32, on the
JAX package's weights of llama-tiny and mixtral-tiny written as a
checkpoint by this file (two safetensors shards and their index):

- each rank's loaded tree is the matching cut of the whole tree bit for bit
  (``load_hf_checkpoint(mesh=, rank=)`` against ``shard_params``): tp heads
  and vocab, tp experts, pp stages (a later stage holding no embedding,
  final norm or head), and the uneven tp of 12 heads over 3 kv heads;
- a tensor of a layer or expert a rank does not hold is never read;
- a ``ckpt=`` engine on tp=2, dp=2 and pp=2 gives the JAX single-device
  engine's greedy tokens on the same weights; rank 0 ships no weights (its
  workers' set-up carries the path, no shard) and each worker holds its
  cut's bytes;
- the URLs serve through the app, and the engine key includes the mesh.
"""

import asyncio
import json
import os

import httpx
import jax
import numpy as np
import pytest
import torch

from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.ops.sampling import SamplerConfig as JaxSampler
from quorum_tpu_torch.config import Config
from quorum_tpu_torch.engine.engine import get_engine_from_ckpt, shutdown_all_engines
from quorum_tpu_torch.models import hf_loader
from quorum_tpu_torch.models.convert import params_from_numpy, shard_params
from quorum_tpu_torch.models.hf_loader import load_hf_checkpoint, write_safetensors
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.ops.sampling import SamplerConfig
from quorum_tpu_torch.parallel import MeshConfig, make_mesh
from quorum_tpu_torch.server.app import create_app

GREEDY = SamplerConfig(temperature=0.0)
PROMPTS = [[3, 4, 5], [(7 + 5 * i) % 500 for i in range(30)]]
N_TOK = 10
MODELS = {
    "llama-tiny": ({"dtype": "float32", "n_layers": "4"}, "llama"),
    "mixtral-tiny": ({"dtype": "float32"}, "mixtral"),
    "llama-12h": ({"dtype": "float32", "n_heads": "12", "n_kv_heads": "3"}, "llama"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hf_tensors(spec, p):
    """(HF name, tensor) of a llama-family tree (nn.Linear's [out, in])."""
    b = p["blocks"]
    yield "model.embed_tokens.weight", p["tok_emb"]
    for i in range(spec.n_layers):
        pre = f"model.layers.{i}."
        yield pre + "input_layernorm.weight", b["attn_norm_w"][i]
        for leaf, proj in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
            yield pre + f"self_attn.{proj}_proj.weight", b[leaf][i].T
        yield pre + "post_attention_layernorm.weight", b["mlp_norm_w"][i]
        if spec.is_moe:
            yield pre + "block_sparse_moe.gate.weight", b["router"][i].T
            for e in range(spec.n_experts):
                for leaf, w in (("moe_w_gate", "w1"), ("moe_w_up", "w3"), ("moe_w_down", "w2")):
                    yield f"{pre}block_sparse_moe.experts.{e}.{w}.weight", b[leaf][i, e].T
        else:
            for leaf, proj in (("w_gate", "gate"), ("w_up", "up"), ("w_down", "down")):
                yield pre + f"mlp.{proj}_proj.weight", b[leaf][i].T
    yield "model.norm.weight", p["final_norm_w"]
    yield "lm_head.weight", p["lm_head"].T


def _write(path, spec, params, model_type):
    cfg = {"model_type": model_type, "vocab_size": spec.vocab_size,
           "hidden_size": spec.d_model, "intermediate_size": spec.d_ff,
           "num_hidden_layers": spec.n_layers, "num_attention_heads": spec.n_heads,
           "num_key_value_heads": spec.n_kv_heads, "head_dim": spec.head_dim,
           "max_position_embeddings": spec.max_seq, "rope_theta": spec.rope_theta,
           "rms_norm_eps": spec.norm_eps, "tie_word_embeddings": False,
           "torch_dtype": "float32"}
    if spec.is_moe:
        cfg.update(num_local_experts=spec.n_experts, num_experts_per_tok=spec.experts_per_token)
    (path / "config.json").write_text(json.dumps(cfg))
    tensors = [(n, t.contiguous()) for n, t in _hf_tensors(spec, params)]
    half = len(tensors) // 2
    files = {"model-00001-of-00002.safetensors": tensors[:half],
             "model-00002-of-00002.safetensors": tensors[half:]}
    for fname, part in files.items():
        write_safetensors(path / fname, dict(part))
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {n: f for f, part in files.items() for n, _ in part}}))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """model → (checkpoint dir, port spec, the whole tree, JAX greedy tokens)."""
    out = {}
    for name, (opts, model_type) in MODELS.items():
        preset = "llama-tiny" if name == "llama-12h" else name
        jspec = jax_resolve_spec(preset, opts)
        jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=21))
        path = tmp_path_factory.mktemp(name)
        full = params_from_numpy(jparams, device="cpu")
        spec = resolve_spec(preset, opts)
        _write(path, spec, full, model_type)
        jeng = JaxEngine(jspec, params=jparams, decode_chunk=4, n_slots=2)
        try:
            want = [jeng.generate(p, max_new_tokens=N_TOK, sampler=JaxSampler(temperature=0.0))
                    .token_ids for p in PROMPTS]
        finally:
            jeng.shutdown()
        out[name] = (str(path), spec, full, want)
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("name,axes", [
    ("llama-tiny", dict(tp=2)), ("llama-tiny", dict(dp=2, tp=2)), ("llama-tiny", dict(pp=2)),
    ("llama-tiny", dict(tp=4)), ("mixtral-tiny", dict(tp=2)), ("mixtral-tiny", dict(pp=2)),
    ("llama-12h", dict(tp=2)),
])
def test_each_rank_loads_exactly_its_cut(ckpts, name, axes):
    path, spec, full, _ = ckpts[name]
    cfg = MeshConfig(**axes)
    mesh = make_mesh(cfg, ["cpu"] * cfg.n_devices)
    for r in range(mesh.size):
        loaded_spec, got = load_hf_checkpoint(path, dtype="float32", device="cpu", mesh=mesh,
                                              rank=r)
        assert loaded_spec == spec
        want = dict(_flat(shard_params(full, mesh, r, spec)))
        got = dict(_flat(got))
        assert sorted(got) == sorted(want)
        for leaf, w in want.items():
            assert (got[leaf] is None and w is None) or torch.equal(got[leaf], w), (r, leaf)
    if axes.get("pp"):
        assert dict(_flat(load_hf_checkpoint(path, dtype="float32", device="cpu", mesh=mesh,
                                             rank=1)[1]))["tok_emb"] is None


def test_a_rank_reads_only_the_tensors_it_holds(ckpts, monkeypatch):
    path, spec, _, _ = ckpts["mixtral-tiny"]
    read = []
    real = hf_loader._TensorDir.req

    def spy(self, name):
        read.append(name)
        return real(self, name)

    monkeypatch.setattr(hf_loader._TensorDir, "req", spy)
    mesh = make_mesh(MeshConfig(pp=2), ["cpu"] * 2)
    load_hf_checkpoint(path, dtype="float32", device="cpu", mesh=mesh, rank=1)
    assert read and all(n.startswith("model.layers.1.") for n in read), read[:4]
    read.clear()
    mesh = make_mesh(MeshConfig(tp=2), ["cpu"] * 2)
    load_hf_checkpoint(path, dtype="float32", device="cpu", mesh=mesh, rank=1)
    experts = {n.split(".experts.")[1].split(".")[0] for n in read if ".experts." in n}
    assert experts == {"2", "3"}  # rank 1 of tp=2 holds experts 2 and 3 of 4


@pytest.mark.parametrize("name,axes", [
    ("llama-tiny", dict(tp=2)), ("llama-tiny", dict(dp=2)), ("llama-tiny", dict(pp=2)),
    ("mixtral-tiny", dict(tp=2)), ("llama-12h", dict(tp=2)),
])
def test_ckpt_engine_on_a_mesh_equals_the_jax_engine(ckpts, name, axes):
    path, spec, full, want = ckpts[name]
    cfg = MeshConfig(**axes)
    mesh = make_mesh(cfg, ["cpu"] * cfg.n_devices, timeout_s=30.0)
    eng = get_engine_from_ckpt(path, dtype="float32", mesh=mesh, decode_chunk=4, n_slots=2)
    try:
        assert get_engine_from_ckpt(path, dtype="float32", mesh=mesh) is eng
        _, kwargs = eng._ranks._setup(1)
        assert kwargs["shard"] is None and kwargs["ckpt"] == (os.path.realpath(path), "float32")
        got = [eng.generate(p, max_new_tokens=N_TOK, sampler=GREEDY).token_ids for p in PROMPTS]
        assert got == want
        cut = [sum(t.numel() * t.element_size() for _, t in _flat(shard_params(full, mesh, r,
                                                                               spec))
                   if t is not None) for r in range(1, mesh.size)]
        assert [rep["weight_bytes"] for rep in eng.rank_reports()] == cut
    finally:
        shutdown_all_engines()


async def _call(app, body):
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as client:
        return await client.post("/v1/chat/completions", json=body,
                                 headers={"Authorization": "Bearer t"})


@pytest.mark.parametrize("query", ["tp=2", "dp=2", "pp=2"])
def test_ckpt_urls_on_a_mesh_serve_through_the_app(ckpts, query):
    path, _, _, _ = ckpts["llama-tiny"]
    url = f"cuda://llama-tiny?ckpt={path}&{query}&device=cpu&dtype=float32&slots=2"
    app = create_app(Config(raw={"settings": {"timeout": 60}, "primary_backends": [
        {"name": "L", "url": url, "model": "m"}]}))
    try:
        eng = app.state["registry"].backends[0].engine
        assert eng.mesh.size == 2
        body = {"model": "m", "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 6, "temperature": 0.0}
        resp = asyncio.run(_call(app, body))
        assert resp.status_code == 200, resp.text
        assert resp.json()["usage"]["completion_tokens"] >= 1
    finally:
        shutdown_all_engines()
