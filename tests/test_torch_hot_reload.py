"""Config hot reload on the port's server (``server/reload.py``): the JAX
package's six scenarios over ``cuda://`` backends. An edit changes routing
on the next request, an untouched backend instance survives, a malformed
edit (bad YAML or a bad shape) keeps the previous config serving, a dropped
engine is shut down and evicted from the engine cache, and watching is off
by default. CPU, llama-tiny."""

import asyncio
import os

import httpx
import pytest
import torch
import yaml

from quorum_tpu_torch.config import load_config
from quorum_tpu_torch.engine.engine import _ENGINES, shutdown_all_engines
from quorum_tpu_torch.server.app import create_app

AUTH = {"Authorization": "Bearer t"}
BODY = {"model": "tiny", "max_tokens": 4, "temperature": 0.0,
        "messages": [{"role": "user", "content": "reload probe"}]}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _release_port_engines():
    yield
    shutdown_all_engines()


def _write(path, raw):
    path.write_text(yaml.safe_dump(raw))
    # The watcher's signature is (mtime_ns, size): nudge the mtime so every
    # edit is observable on a filesystem with a coarse clock.
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))


def _cfg(backends, timeout=120):
    return {"settings": {"timeout": timeout}, "primary_backends": backends}


def _tiny(name, seed):
    return {"name": name, "model": "tiny",
            "url": f"cuda://llama-tiny?device=cpu&seed={seed}&max_seq=256&slots=2&max_tokens=4"}


def _client(app):
    return httpx.AsyncClient(transport=httpx.ASGITransport(app=app), base_url="http://t")


async def _wait_reload_window():
    await asyncio.sleep(0.6)  # the watcher stats the file at most every 0.5 s


async def test_edit_changes_routing_and_keeps_live_engine(tmp_path):
    path = tmp_path / "config.yaml"
    _write(path, _cfg([_tiny("A", seed=1)]))
    cfg = load_config(path)
    assert cfg.source_path == path
    app = create_app(cfg, watch_config=True)
    async with _client(app) as client:
        r1 = await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        assert r1.status_code == 200 and r1.json()["backend"] == "A"
        engine_before = app.state["registry"].get("A").engine
        # A renamed backend on the same URL: a new backend instance, which
        # the engine cache attaches to the live engine.
        _write(path, _cfg([_tiny("B", seed=1)]))
        await _wait_reload_window()
        r2 = await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        assert r2.status_code == 200 and r2.json()["backend"] == "B"
        assert (await client.get("/v1/models")).json()["data"][0]["owned_by"] == "B"
        assert app.state["registry"].get("B").engine is engine_before


async def test_unchanged_backend_instance_is_reused(tmp_path):
    path = tmp_path / "config.yaml"
    _write(path, _cfg([_tiny("A", seed=1)], timeout=120))
    app = create_app(load_config(path), watch_config=True)
    async with _client(app) as client:
        await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        backend_before = app.state["registry"].get("A")
        _write(path, _cfg([_tiny("A", seed=1)], timeout=77))  # the timeout only
        await _wait_reload_window()
        await client.get("/v1/models")
        assert app.state["registry"].get("A") is backend_before
        assert app.state["config"].timeout == 77.0


@pytest.mark.parametrize("bad", ["primary_backends: [:::not yaml",
                                 "primary_backends:\n  - just-a-string\n"],
                         ids=["malformed_yaml", "valid_yaml_bad_shape"])
async def test_bad_edit_keeps_previous_config(tmp_path, bad):
    path = tmp_path / "config.yaml"
    _write(path, _cfg([_tiny("A", seed=1)]))
    app = create_app(load_config(path), watch_config=True)
    async with _client(app) as client:
        assert (await client.post("/v1/chat/completions", json=BODY,
                                  headers=AUTH)).status_code == 200
        path.write_text(bad)
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
        await _wait_reload_window()
        r2 = await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        assert r2.status_code == 200 and r2.json()["backend"] == "A"
        # ...and the next good edit applies cleanly.
        _write(path, _cfg([_tiny("C", seed=1)]))
        await _wait_reload_window()
        r3 = await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        assert r3.status_code == 200 and r3.json()["backend"] == "C"


async def test_dropped_engine_is_released(tmp_path):
    """An edit that drops a ``cuda://`` engine shuts it down and evicts it
    from the engine cache: its weights, cache and graphs are gone."""
    path = tmp_path / "config.yaml"
    _write(path, _cfg([_tiny("A", seed=41)]))
    app = create_app(load_config(path), watch_config=True)
    async with _client(app) as client:
        await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        old = app.state["registry"].get("A").engine
        assert any(e is old for e in _ENGINES.values())
        _write(path, _cfg([_tiny("A", seed=42)]))  # other weights: no keeper
        await _wait_reload_window()
        r = await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        assert r.status_code == 200
        new = app.state["registry"].get("A").engine
    assert new is not old
    assert not any(e is old for e in _ENGINES.values())
    assert old.params is None and old._ck is None
    assert not old.health()["scheduler_alive"]


async def test_shared_engine_survives_dropping_one_of_its_backends(tmp_path):
    path = tmp_path / "config.yaml"
    _write(path, _cfg([_tiny("A", seed=43), _tiny("B", seed=43)]))
    app = create_app(load_config(path), watch_config=True)
    async with _client(app) as client:
        engine = app.state["registry"].get("A").engine
        assert app.state["registry"].get("B").engine is engine
        _write(path, _cfg([_tiny("A", seed=43)]))
        await _wait_reload_window()
        r = await client.post("/v1/chat/completions", json=BODY, headers=AUTH)
        assert r.status_code == 200
    assert engine.health()["scheduler_alive"] and engine.params is not None


async def test_watch_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("QUORUM_TPU_CONFIG_WATCH", raising=False)
    path = tmp_path / "config.yaml"
    _write(path, _cfg([_tiny("A", seed=1)]))
    app = create_app(load_config(path))
    async with _client(app) as client:
        _write(path, _cfg([_tiny("B", seed=1)]))
        await _wait_reload_window()
        assert (await client.get("/v1/models")).json()["data"][0]["owned_by"] == "A"


async def test_watch_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("QUORUM_TPU_CONFIG_WATCH", "1")
    path = tmp_path / "config.yaml"
    _write(path, _cfg([_tiny("A", seed=1)]))
    app = create_app(load_config(path))
    async with _client(app) as client:
        _write(path, _cfg([_tiny("B", seed=1)]))
        await _wait_reload_window()
        assert (await client.get("/v1/models")).json()["data"][0]["owned_by"] == "B"
