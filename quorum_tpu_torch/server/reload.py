"""Config hot reload, in process and incremental: the server's engines hold
weights, KV caches and captured graphs that take long to rebuild, so a
config edit must not restart the process.

The watcher stats the config file when a request arrives (at most every
``_POLL_INTERVAL_S``). On a change it parses the YAML again and swaps in a
rebuilt registry that REUSES every backend whose name, url, model and
retries are unchanged, so live ``cuda://`` engines keep serving across edits
to strategies, timeouts or other backends. A dropped backend is closed, and
its engine (unless a kept backend shares it) is shut down and evicted from
the engine cache, so its weights, cache and graphs leave the card. A
malformed edit keeps the previous config and registry and logs why.

Opt-in: ``create_app(watch_config=True)`` or ``QUORUM_TPU_CONFIG_WATCH=1``,
with a file-backed config.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from pathlib import Path
from typing import Any

from quorum_tpu_torch.backends.registry import BackendRegistry, rebuild_registry
from quorum_tpu_torch.config import Config

logger = logging.getLogger(__name__)

# Floor between stat() calls: request-driven polling stays ~free under load.
_POLL_INTERVAL_S = 0.5


class Runtime:
    """The app's live (config, registry) pair: handlers read through it, so
    a reload's swap is atomic for the requests after it."""

    __slots__ = ("cfg", "reg")

    def __init__(self, cfg: Config, reg: BackendRegistry):
        self.cfg = cfg
        self.reg = reg


class ConfigWatcher:
    def __init__(self, path: str | os.PathLike, runtime: Runtime, overrides: dict[str, Any]):
        self.path = Path(path)
        self._runtime = runtime
        self._overrides = dict(overrides)
        self._sig = self._stat_sig()
        self._next_check = 0.0
        self._busy = False

    def _stat_sig(self) -> tuple[int, int] | None:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    async def poll(self) -> None:
        """Reload if the file changed (called as a request arrives)."""
        if self._busy:
            return  # a rebuild is in flight; serve on the previous config
        now = time.monotonic()
        if now < self._next_check:
            return
        self._next_check = now + _POLL_INTERVAL_S
        sig = self._stat_sig()
        if sig == self._sig:
            return
        self._sig = sig
        self._busy = True
        try:
            await self._reload()
        finally:
            self._busy = False

    async def _reload(self) -> None:
        rt = self._runtime

        def build() -> tuple[Config, BackendRegistry, list]:
            import yaml  # only a watching server reads YAML again

            raw: Any = yaml.safe_load(self.path.read_text())
            if not isinstance(raw, dict):
                raise ValueError(f"config root must be a mapping, got {type(raw).__name__}")
            new_cfg = Config(raw=raw, source_path=self.path)
            new_reg, dropped = rebuild_registry(new_cfg, rt.reg, self._overrides)
            return new_cfg, new_reg, dropped

        # Off the event loop: building a changed cuda:// backend loads
        # weights, and the streams in flight keep draining on the previous
        # registry meanwhile. ANY failure (a YAML typo, a bad shape, a bad
        # cuda:// URL) keeps the previous config.
        try:
            new_cfg, new_reg, dropped = await asyncio.to_thread(build)
        except Exception as e:
            logger.error("Config reload from %s failed (%s); keeping the previous "
                         "configuration", self.path, e)
            return
        rt.cfg, rt.reg = new_cfg, new_reg
        logger.info("Config reloaded from %s: %d backend(s) active, %d dropped",
                    self.path, len(new_reg), len(dropped))
        kept = {id(getattr(b, "engine", None)) for b in new_reg.backends} - {id(None)}
        released: set[int] = set()
        for b in dropped:
            close = getattr(b, "aclose", None)
            if close is not None:
                try:
                    await close()
                except Exception:
                    logger.exception("Closing dropped backend %s failed", b.name)
            engine = getattr(b, "engine", None)
            if engine is not None and id(engine) not in kept and id(engine) not in released:
                released.add(id(engine))
                from quorum_tpu_torch.engine.engine import release_engine

                try:
                    await asyncio.to_thread(release_engine, engine)
                except Exception:
                    logger.exception("Releasing dropped backend %s's engine failed", b.name)
