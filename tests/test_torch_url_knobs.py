"""``cuda://`` URL options and request knobs against ``tpu://``'s.

- Every URL option outside the port's known set (its own options, the
  ``ModelSpec`` fields, ``device``) is a ValueError at ``from_spec`` that
  names the option, before any engine exists; the ``tpu://`` options the
  port does not serve yet say so. Every known option still builds.
- The six paging and prefix-store options (``kv_pages``, ``kv_page_size``,
  ``kv_pool_pages``, ``prefix_store``, ``prefix_store_bytes``,
  ``prefix_store_chunk``) parse and build the engine they name; their
  misuse is refused in ``tpu://``'s words.
- ``decode_loop=`` is validated at config time, as ``tpu://`` validates it
  (tests/test_decode_loop.py::test_url_knobs_validated_at_config_time).
- ``top_k`` in a request body is ignored, as ``tpu://`` ignores it: a body
  with ``top_k`` samples exactly what the body without it samples, and
  ``-1`` or ``"5"`` is not a 400.

llama-tiny on the CPU.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from quorum_tpu.backends.tpu_backend import TpuBackend
from quorum_tpu.config import BackendSpec as JaxBackendSpec
from quorum_tpu.engine.engine import InferenceEngine as JaxEngine
from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu_torch.backends import cuda_backend
from quorum_tpu_torch.backends.cuda_backend import CudaBackend
from quorum_tpu_torch.config import BackendSpec
from quorum_tpu_torch.engine import engine as engine_mod
from quorum_tpu_torch.engine.engine import InferenceEngine, shutdown_all_engines
from quorum_tpu_torch.models.convert import params_from_numpy
from quorum_tpu_torch.models.model_config import resolve_spec

BASE = "cuda://llama-tiny?device=cpu&dtype=float32"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_engine(monkeypatch):
    """Fail the test if a refused URL gets as far as building an engine."""
    def refuse(*args, **kwargs):
        raise AssertionError("an engine was built for a URL that must be refused")

    monkeypatch.setattr(cuda_backend, "get_engine", refuse)


def _from_url(url: str) -> CudaBackend:
    return CudaBackend.from_spec(BackendSpec(name="m", url=url, model="m"))


@pytest.mark.parametrize("option", ["decode_lop", "slot", "n_layer", "Seed", "foo"])
def test_unknown_options_are_refused_by_name(option, no_engine):
    with pytest.raises(ValueError, match=rf"unknown cuda:// option {option}="):
        _from_url(f"{BASE}&{option}=4")


@pytest.mark.parametrize("option,value", [
    ("dp", "2"), ("pp", "2"),
    ("disagg", "1+1"), ("flash_decode", "1"),
])
def test_tpu_only_options_say_they_are_not_served_yet(option, value, no_engine):
    # flash_decode= is refused for good (test_flash_decode_refusal_is_permanent).
    tail = ", and will not" if option == "flash_decode" else " yet"
    with pytest.raises(ValueError, match=rf"does not serve the {option}= option{tail}"):
        _from_url(f"{BASE}&{option}={value}")


@pytest.mark.parametrize("tail,want", [
    ("&kv_pages=1", {"kv_pages": True, "kv_page_size": 16, "kv_pool_pages": 2 * 8}),
    ("&kv_pages=1&kv_page_size=32&kv_pool_pages=5&kv_quant=int8",
     {"kv_pages": True, "kv_page_size": 32, "kv_pool_pages": 5}),
    ("&prefix_store=host&prefix_store_bytes=512m&prefix_store_chunk=32",
     {"store": (512 << 20, 32)}),
    ("&kv_pages=yes&prefix_store=host", {"kv_pages": True, "store": (1 << 30, 16)}),
    ("&kv_pages=1&kv_page_size=24", "refused"),
    ("&prefix_store_bytes=1g", "refused"),
    ("&prefix_store=host&members=3&member=0", "refused"),
    ("&kv_pages=1&ensemble=2", "refused"),
    ("&prefix_store=host&prefix_store_bytes=0", "refused"),
], ids=["kv_pages", "page-geometry-int8", "store-sized", "both", "page-size-24",
        "store-bytes-alone", "store-members", "pages-ensemble", "store-bytes-0"])
def test_paging_and_store_options_build_or_refuse_in_tpu_words(tail, want):
    """The six paging and prefix-store options parse and build the engine
    they name (``slots=2&max_seq=128&prefill_chunk=16``: 16-token pages,
    a 16-page default pool); their misuse is refused in tpu://'s words."""
    base = "&slots=2&max_seq=128&prefill_chunk=16&n_layers=1"
    try:
        if want == "refused":
            with pytest.raises(ValueError) as got:
                _from_url(f"{BASE}{base}{tail}")
            assert str(got.value) == _jax_refusal(f"tpu://llama-tiny?dtype=float32{base}{tail}")
            return
        eng = _from_url(f"{BASE}{base}{tail}").engine
        for name in ("kv_pages", "kv_page_size", "kv_pool_pages"):
            if name in want:
                assert getattr(eng, name) == want[name], name
        if "store" in want:
            assert (eng.prefix_store.max_bytes, eng.prefix_store.chunk_tokens) == want["store"]
        else:
            assert eng.prefix_store is None
        if eng.kv_pages:  # a dense URL of the same model never shares the paged engine
            assert _from_url(f"{BASE}{base}").engine is not eng
    finally:
        shutdown_all_engines()


def _jax_refusal(url: str) -> str:
    with pytest.raises(ValueError) as e:
        TpuBackend.from_spec(JaxBackendSpec(name="m", url=url, model="m"))
    return str(e.value)


@pytest.mark.parametrize("tail", [
    "&ckpt={dir}&spec_model=llama-tiny",
    "&spec_model=llama-tiny&spec_ckpt={dir}",
    "&spec_ckpt={dir}",
    "&spec_model=llama-tiny&spec_decode=0&n_layers=1&max_seq=64",
], ids=["spec_model-with-ckpt", "spec_model-with-spec_ckpt", "spec_ckpt-without-config",
        "draft-with-spec_decode-0"])
def test_spec_knob_misuse_is_refused_in_jax_words(tail, tmp_path):
    """The four refusals of the draft knobs: a random-init draft beside
    real ckpt= weights, two draft sources, a spec_ckpt= directory with no
    config.json (before any weights load), and an explicit spec_decode=0
    beside a draft (the engine's). Each message is the tpu:// backend's."""
    url = tail.format(dir=tmp_path)
    with pytest.raises(ValueError) as e:
        _from_url(f"{BASE}{url}")
    assert str(e.value) == _jax_refusal(f"tpu://llama-tiny?dtype=float32{url}")
    shutdown_all_engines()


@pytest.mark.parametrize("value", ["0", "1"])
def test_flash_decode_refusal_is_permanent(value, no_engine):
    """No option turns a kernel off on the card: the refusal of tpu://'s
    flash_decode= switch says so, and never that it is coming."""
    with pytest.raises(ValueError) as e:
        _from_url(f"{BASE}&flash_decode={value}")
    assert str(e.value) == (
        "cuda:// does not serve the flash_decode= option, and will not: decode "
        "attention always runs its kernel on the card (the plain version only on "
        "the CPU), and no option turns a kernel off")
    assert "yet" not in str(e.value)


@pytest.mark.parametrize("value", ["0", "9999", "-2", "65"])
def test_decode_loop_validated_at_config_time(value, no_engine):
    with pytest.raises(ValueError, match="decode_loop"):
        _from_url(f"{BASE}&decode_loop={value}")


def test_every_known_option_still_builds():
    urls = [
        f"{BASE}&slots=2&decode_chunk=4&decode_pipeline=1&decode_loop=6&prefill_chunk=16"
        "&prefix_cache=0&seed=3&queue=8&max_tokens=5&n_layers=1&max_seq=64&rope_theta=500000",
        f"{BASE}&members=2&member=1&member_seeds=shared&quorum_dedup=1&slots=1&n_layers=1",
        f"{BASE}&ensemble=2&slots=1&n_layers=1&norm_eps=1e-6",
        f"{BASE}&spec_model=llama-tiny&spec_seed=1&spec_decode=2&slots=1&n_layers=1",
    ]
    shutdown_all_engines()  # engines an earlier file on this worker left cached
    try:
        first = _from_url(urls[0])
        eng = first.engine
        assert (eng.n_slots, eng.decode_chunk, eng.decode_pipeline, eng.decode_loop,
                eng.prefill_chunk, eng.prefix_cache, eng.spec.n_layers,
                eng.spec.max_seq) == (2, 4, 1, 4, 16, False, 1, 64)
        assert first.default_max_tokens == 5 and eng.max_pending == 8
        stacked = _from_url(urls[1])
        assert (stacked.member, stacked.engine.members, stacked.engine.quorum_dedup) == (1, 2, True)
        assert _from_url(urls[2]).engine.ensemble == 2
        drafted = _from_url(urls[3]).engine
        assert drafted.spec_decode == 2 and drafted._draft_rt is not None
        assert len(engine_mod._ENGINES) == 4
    finally:
        shutdown_all_engines()


# ---- top_k on the wire ------------------------------------------------------

@pytest.fixture(scope="module")
def backends():
    opts = {"dtype": "float32"}
    jspec = jax_resolve_spec("llama-tiny", opts)
    jparams = jax.tree.map(np.asarray, jax_init_params(jspec, seed=11))
    jeng = JaxEngine(jspec, params=jparams, decode_chunk=4)
    teng = InferenceEngine(resolve_spec("llama-tiny", opts), device="cpu", decode_chunk=4,
                           params=params_from_numpy(jparams, device="cpu"))
    yield {"tpu": TpuBackend("m", jeng), "cuda": CudaBackend("m", teng, model_id="llama-tiny")}
    jeng.shutdown()
    teng.shutdown()


BODY = {"model": "m", "messages": [{"role": "user", "content": "name a colour"}],
        "max_tokens": 12, "temperature": 0.9, "top_p": 0.95, "seed": 3}


@pytest.mark.parametrize("scheme", ["cuda", "tpu"])
@pytest.mark.parametrize("top_k", [40, 1, -1, "5"], ids=["40", "1", "minus1", "str5"])
def test_top_k_is_ignored_on_the_wire(backends, scheme, top_k):
    backend = backends[scheme]

    def content(body):
        resp = asyncio.run(backend.complete(body, {}, 60))
        assert resp.status_code == 200
        return resp.body["choices"][0]["message"]["content"]

    assert content({**BODY, "top_k": top_k}) == content(dict(BODY))


def test_top_k_is_ignored_when_streaming(backends):
    backend = backends["cuda"]

    async def text(body):
        out = []
        async for chunk in backend.stream({**body, "stream": True}, {}, 60):
            out.extend(c["delta"].get("content", "") for c in chunk.get("choices", []))
        return "".join(out)

    assert asyncio.run(text({**BODY, "top_k": 7})) == asyncio.run(text(dict(BODY)))
