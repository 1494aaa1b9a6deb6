"""Backend registry: turn the config's ``primary_backends`` into live
backends, built once per server (in-process models load weights once).

Scheme dispatch, each backend module imported only when a config names
its scheme:

  cuda://            → CudaBackend (in-process model)
  http:// https://   → HttpBackend (OpenAI-compatible relay; imports httpx)

Other schemes are skipped with a warning.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable

from quorum_tpu_torch.config import BackendSpec, Config

logger = logging.getLogger(__name__)


class BackendRegistry:
    def __init__(self, backends: Iterable[Any] = ()):
        self._by_name: dict[str, Any] = {}
        # The BackendSpec each backend was built from, where known: the
        # identity a config reload compares to reuse a live backend.
        self._spec_by_name: dict[str, BackendSpec] = {}
        for b in backends:
            self.add(b)

    def add(self, backend, spec: BackendSpec | None = None) -> None:
        self._by_name[backend.name] = backend
        if spec is not None:
            self._spec_by_name[backend.name] = spec

    def spec_of(self, name: str) -> BackendSpec | None:
        return self._spec_by_name.get(name)

    def get(self, name: str):
        return self._by_name.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._by_name)

    @property
    def backends(self) -> list:
        """Backends in config order."""
        return list(self._by_name.values())

    def select(self, names: list[str] | str | None) -> list:
        """Resolve ``source_backends``: ``"all"``, None or [] → every backend,
        else the named ones (an unknown name is skipped with a warning). When
        no name resolves the result is empty, and the caller reports a
        configuration error instead of fanning out to excluded backends."""
        if names is None or names == "all" or names == []:
            return self.backends
        if isinstance(names, str):  # one backend's name, not a list
            names = [names]
        out = []
        for n in names:
            b = self.get(n)
            if b is None:
                logger.warning("source_backends entry %r is not a configured backend", n)
            else:
                out.append(b)
        return out

    async def aclose(self) -> None:
        for b in self.backends:
            close = getattr(b, "aclose", None)
            if close is not None:
                await close()


def _build_cuda_backend(spec: BackendSpec):
    from quorum_tpu_torch.backends.cuda_backend import CudaBackend

    return CudaBackend.from_spec(spec)


def _build_http_backend(spec: BackendSpec):
    from quorum_tpu_torch.backends.http_backend import HttpBackend  # imports httpx

    return HttpBackend(spec.name, spec.url, spec.model, retries=spec.retries)


SCHEME_FACTORIES: dict[str, Callable[[BackendSpec], Any]] = {
    "cuda": _build_cuda_backend, "http": _build_http_backend, "https": _build_http_backend}


def build_registry(config: Config, **overrides: Any) -> BackendRegistry:
    """Construct a backend for every configured backend with a url.
    ``overrides`` maps a backend name to a pre-built instance (tests inject
    backends built on converted weights this way)."""
    return rebuild_registry(config, BackendRegistry(), overrides)[0]


def rebuild_registry(config: Config, old: BackendRegistry,
                     overrides: dict[str, Any]) -> tuple[BackendRegistry, list]:
    """The registry of ``config``, reusing every backend of ``old`` whose
    name, url, model and retries are unchanged (a config edit never tears
    down a ``cuda://`` engine it did not touch). Returns ``(registry,
    dropped)``: the old backends no longer referenced, for the caller to
    close. A backend that fails to build raises, and a reload keeps the
    old registry."""
    reg = BackendRegistry()
    for spec in config.valid_backends:
        if spec.name in overrides:
            reg.add(overrides[spec.name])
            continue
        prev, prev_spec = old.get(spec.name), old.spec_of(spec.name)
        if (prev is not None and prev_spec is not None and prev_spec.url == spec.url
                and prev_spec.model == spec.model and prev_spec.retries == spec.retries):
            reg.add(prev, spec=spec)
            continue
        factory = SCHEME_FACTORIES.get(spec.scheme)
        if factory is None:
            logger.warning("backend %s: URL scheme %r is not served by the port yet, skipped",
                           spec.name, spec.scheme)
            continue
        reg.add(factory(spec), spec=spec)
    for name, backend in overrides.items():
        if name not in reg:
            reg.add(backend)
    kept = {id(b) for b in reg.backends}
    return reg, [b for b in old.backends if id(b) not in kept]
