"""The port's HF checkpoint loader, ``ckpt=`` backends and HF tokenizers
against the JAX package's, on tiny random HuggingFace models saved locally
(``transformers`` + ``save_pretrained``; nothing is downloaded). Only
these tests need ``transformers``; the port's loading path never imports it.

For every family ``spec_from_hf_config`` accepts (gpt2, llama with GQA,
llama3 rope scaling, llama and qwen2 attention bias, mistral with a sliding
window of 4 over 8 tokens, gemma, mixtral) and for the
``pytorch_model.bin`` and sharded-safetensors routes:

- every leaf the port loads equals the JAX loader's exactly (float32), the
  same leaves ``None``;
- the port's ``forward_logits`` equals JAX's within 1e-4 and transformers'
  own forward within JAX's 2e-3;
- a ``cuda://…?ckpt=DIR&device=cpu`` engine's greedy stream equals the
  greedy continuation of the cache-free forward.

Also: the port's safetensors reader against ``safetensors.safe_open`` byte
for byte (F32, F16, BF16, a scalar, an empty tensor); the two tokenizer
fallbacks (a raising chat template, a tokenizer directory that fails to
load) against the JAX package's; the templated ``ckpt=`` backend end to
end; engine sharing by (path, dtype, device); the refusals.
"""

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.engine import tokenizer as jax_tok
from quorum_tpu.models.hf_loader import load_hf_checkpoint as jax_load
from quorum_tpu.models.transformer import forward_logits as jax_forward
from quorum_tpu_torch.backends import cuda_backend
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine import engine as engine_mod
from quorum_tpu_torch.engine import tokenizer as port_tok
from quorum_tpu_torch.engine.engine import get_engine_from_ckpt, shutdown_all_engines
from quorum_tpu_torch.models import hf_loader
from quorum_tpu_torch.models.hf_loader import SafetensorsFile, load_hf_checkpoint
from quorum_tpu_torch.models.transformer import forward_logits
from quorum_tpu_torch.ops.sampling import SamplerConfig

transformers = pytest.importorskip("transformers")

TOKENS = np.array([[3, 17, 5, 9, 250, 11, 42, 7]], dtype=np.int64)
LONG = np.arange(40, dtype=np.int64)[None, :] % 500 + 3
SMALL = dict(vocab_size=512, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _randomize_biases(model):
    """transformers zero-inits biases: randomize them so the bias mapping
    is exercised, not compared against zeros."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, 0.5)
    return model


def _gpt2():
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=512, n_positions=64, n_embd=32, n_layer=2, n_head=4))


def _llama(**kw):
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **{**SMALL, "rope_theta": 10000.0, "tie_word_embeddings": False, **kw}))


FAMILIES = {
    "gpt2": (_gpt2, TOKENS, True),
    "gpt2_bin": (_gpt2, TOKENS, False),
    "llama_gqa": (_llama, TOKENS, True),
    "llama_sharded": (_llama, TOKENS, "4KB"),
    "llama3_rope_scaling": (lambda: _llama(max_position_embeddings=128, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}), LONG, True),
    "llama_attention_bias": (lambda: _randomize_biases(_llama(
        num_key_value_heads=4, attention_bias=True, tie_word_embeddings=True)), TOKENS, True),
    "qwen2": (lambda: _randomize_biases(transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **SMALL, tie_word_embeddings=False))), TOKENS, True),
    "mistral": (lambda: transformers.MistralForCausalLM(transformers.MistralConfig(
        **SMALL, sliding_window=4, tie_word_embeddings=False)), TOKENS, True),
    "gemma": (lambda: transformers.GemmaForCausalLM(transformers.GemmaConfig(
        **SMALL, head_dim=8)), TOKENS, True),
    "mixtral": (lambda: transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **SMALL, num_local_experts=4, num_experts_per_tok=2, tie_word_embeddings=False)),
        TOKENS, True),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def checkpoint(request, tmp_path_factory):
    make, tokens, how = FAMILIES[request.param]
    torch.manual_seed(0)
    model = make().eval()
    path = tmp_path_factory.mktemp(request.param)
    if isinstance(how, str):  # a shard size: several *.safetensors files
        model.save_pretrained(path, safe_serialization=True, max_shard_size=how)
        assert len(list(path.glob("*.safetensors"))) > 1
    else:
        model.save_pretrained(path, safe_serialization=how)
    with torch.no_grad():
        hf = model(torch.from_numpy(tokens)).logits.float().numpy()
    return request.param, path, tokens, hf


def _assert_same_tree(jparams, tparams):
    for name, want in jparams.items():
        if name == "blocks":
            continue
        got = tparams[name]
        assert (want is None) == (got is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert set(tparams) == set(jparams) and set(tparams["blocks"]) == set(jparams["blocks"])
    for name, want in jparams["blocks"].items():
        got = tparams["blocks"][name]
        assert (want is None) == (got is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def test_leaves_and_logits_match_jax_and_transformers(checkpoint):
    family, path, tokens, hf = checkpoint
    jspec, jparams = jax_load(path, dtype="float32")
    spec, params = load_hf_checkpoint(path, dtype="float32", device="cpu")
    assert dataclasses_equal(spec, jspec)
    assert all(t is None or t.dtype == torch.float32 for t in _leaves(params))
    _assert_same_tree(jparams, params)
    want = np.asarray(jax_forward(jparams, jspec, jnp.asarray(tokens)))
    got = forward_logits(params, spec, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, hf, atol=2e-3, rtol=1e-3)
    if family == "mixtral":
        assert spec.is_moe and tuple(params["blocks"]["moe_w_down"].shape) == (2, 4, 64, 32)


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _leaves(params):
    yield from (v for k, v in params.items() if k != "blocks")
    yield from params["blocks"].values()


def test_ckpt_engine_greedy_equals_the_forward(checkpoint):
    """``cuda://<id>?ckpt=DIR&device=cpu`` serves the checkpoint: its greedy
    stream is the greedy continuation of the cache-free forward."""
    family, path, _, _ = checkpoint
    prompt = [3, 17, 5, 9, 250, 11]
    try:
        b = CudaBackend.from_spec(BackendSpec(
            name="C", url=f"cuda://{family}?ckpt={path}&device=cpu&dtype=float32"))
        got = b.engine.generate(prompt, max_new_tokens=6,
                                sampler=SamplerConfig(temperature=0.0)).token_ids
        spec, params = b.engine.spec, b.engine.params
        seq = list(prompt)
        for _ in range(6):
            logits = forward_logits(params, spec, torch.tensor([seq]))[0, -1]
            seq.append(int(logits.argmax()))
        assert got == seq[len(prompt):]
    finally:
        shutdown_all_engines()


def test_safetensors_reader_matches_safe_open_byte_for_byte(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=gen),
        "f16": torch.randn((7,), generator=gen).half(),
        "bf16": torch.randn((2, 3, 4), generator=gen).bfloat16(),
        "scalar_f32": torch.tensor(1.5),
        "empty_bf16": torch.zeros((0, 4), dtype=torch.bfloat16),
    }
    path = tmp_path / "t.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    ours = SafetensorsFile(path)
    assert set(ours.keys()) == set(tensors)
    with safe_open(str(path), framework="pt") as ref:
        for name in tensors:
            want, got = ref.get_tensor(name), ours.get(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(_raw(got), _raw(want)), name
            ours.release(name)  # pages dropped; a read faults them back
            assert torch.equal(_raw(ours.get(name)), _raw(want)), name
    ours.close()


def _raw(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _write_chat_tokenizer(dirpath, template):
    """A tiny offline word-level HF tokenizer with a chat template."""
    from tokenizers import Tokenizer as RawTokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<unk>": 0, "hello": 1, "world": 2, "hi": 3, "be": 4, "brief": 5}
    raw = RawTokenizer(WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = Whitespace()
    raw.save(str(dirpath / "tokenizer.json"))
    (dirpath / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>",
        "chat_template": template}))


MSGS = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": [{"type": "text", "text": "hi"}]}]


def test_raising_chat_template_falls_back_like_jax(tmp_path, caplog):
    _write_chat_tokenizer(tmp_path, "{{ raise_exception('no template for you') }}")
    want = jax_tok.HFTokenizer(str(tmp_path)).render_chat(MSGS)
    with caplog.at_level("WARNING"):
        got = port_tok.HFTokenizer(str(tmp_path)).render_chat(MSGS)
    assert got == want == port_tok.render_chat(MSGS)
    assert "chat_template failed" in caplog.text


def test_tokenizer_dir_that_fails_to_load_gives_bytes_like_jax(tmp_path, caplog):
    (tmp_path / "tokenizer.json").write_text("{ not json")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast"}))
    want = jax_tok.get_tokenizer(512, str(tmp_path))
    with caplog.at_level("WARNING"):
        got = port_tok.get_tokenizer(512, str(tmp_path))
    assert type(want).__name__ == type(got).__name__ == "ByteTokenizer"
    assert got.encode("hello") == want.encode("hello") and got.eos_id == want.eos_id
    assert "failed to load the tokenizer" in caplog.text


@pytest.fixture
def gpt2_ckpt(tmp_path):
    torch.manual_seed(0)
    _gpt2().eval().save_pretrained(tmp_path, safe_serialization=True)
    yield tmp_path
    shutdown_all_engines()


async def test_ckpt_backend_uses_checkpoint_chat_template(gpt2_ckpt):
    """The templated checkpoint tokenizer shapes the prompt end to end, its
    EOS is the engine's, and the request completes."""
    _write_chat_tokenizer(gpt2_ckpt, "{% for m in messages %}<|{{ m.role }}|>"
                                     "{{ m.content }}{% endfor %}<|assistant|>")
    b = CudaBackend.from_spec(BackendSpec(
        name="T", url=f"cuda://gpt2?ckpt={gpt2_ckpt}&max_tokens=4&device=cpu"))
    assert isinstance(b.tokenizer, port_tok.HFTokenizer)
    plan = b._plan({"messages": [{"role": "user", "content": "hello world"}]})
    assert plan["prompt_ids"] == b.tokenizer.encode("<|user|>hello world<|assistant|>")
    res = await b.complete({"messages": [{"role": "user", "content": "hello"}]}, {}, 60.0)
    assert res.ok and res.body["object"] == "chat.completion"
    assert 1 <= res.body["usage"]["completion_tokens"] <= 4


def test_ckpt_engines_are_shared_and_seed_offsets_sampling(gpt2_ckpt):
    urls = [f"cuda://gpt2?ckpt={gpt2_ckpt}&device=cpu&seed=0",
            f"cuda://gpt2?ckpt={gpt2_ckpt}&device=cpu&seed=1&dtype=bfloat16"]
    a, b = (CudaBackend.from_spec(BackendSpec(name=f"M{i}", url=u)) for i, u in enumerate(urls))
    assert a.engine is b.engine  # dtype=None is the default bf16: loaded once
    assert a.engine.spec.dtype == "bfloat16" and a.engine.params["tok_emb"].dtype == torch.bfloat16
    assert (a.rng_offset, b.rng_offset) == (0, 1)
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 12,
            "temperature": 1.0}
    outs = [asyncio.run(x.complete(dict(body), {}, 60.0)).body["choices"][0]["message"]
            ["content"] for x in (a, b)]
    assert outs[0] != outs[1]
    f32 = CudaBackend.from_spec(BackendSpec(
        name="F", url=f"cuda://gpt2?ckpt={gpt2_ckpt}&device=cpu&dtype=float32"))
    assert f32.engine is not a.engine
    assert get_engine_from_ckpt(str(gpt2_ckpt), device="cpu") is a.engine


@pytest.fixture
def no_load(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the checkpoint was read for a URL that must be refused")

    monkeypatch.setattr(hf_loader, "load_hf_checkpoint", refuse)


@pytest.mark.parametrize("extra,match", [
    ("members=2&member=1", "members=N does not apply to ckpt= backends"),
    ("ensemble=2", "ensemble members are seeded random inits"),
    ("member_seeds=shared", "member_seeds=/quorum_dedup= do not apply"),
    ("quorum_dedup=1", "member_seeds=/quorum_dedup= do not apply"),
    ("n_layers=1", "the n_layers= override does not apply"),
    ("max_seq=4096", "the max_seq= override does not apply"),
])
def test_ckpt_refusals_name_the_knob(extra, match, no_load, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(ValueError, match=match):
        CudaBackend.from_spec(BackendSpec(
            name="R", url=f"cuda://gpt2?ckpt={tmp_path}&device=cpu&{extra}"))
    assert not any(k[0] == "ckpt" for k in engine_mod._ENGINES)


def test_ckpt_option_is_served_not_refused():
    assert "ckpt" in cuda_backend._OPTIONS and "ckpt" not in cuda_backend._NOT_YET
