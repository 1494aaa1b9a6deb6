"""Configuration: the JAX package's ``config.yaml`` schema, as far as the
port serves it.

  settings.timeout                                request timeout (seconds)
  primary_backends[] {name, url, model, retries}  backend registry
  iterations.aggregation.strategy                 "concatenate" | "aggregate"
  strategy.concatenate {...}                      concatenate parameters
  strategy.aggregate {...}                        aggregate parameters

with ``cuda://<model-id>?<spec overrides>&slots=&decode_chunk=&seed=&device=``
URLs for in-process models and ``http(s)://`` URLs for OpenAI-compatible
relays. A config is a dict (:class:`Config`) or a YAML file
(:func:`load_config`, which imports ``yaml`` only when called).
"""

from __future__ import annotations

import copy
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any
from urllib.parse import parse_qsl, urlparse

from quorum_tpu_torch.filtering import DEFAULT_THINKING_TAGS as _BASE_THINKING_TAGS

logger = logging.getLogger(__name__)

DEFAULT_CONFIG: dict[str, Any] = {"primary_backends": [], "settings": {"timeout": 60}}

# The shipped config lists "Thought" beside "thought"; matching ignores case,
# so it is redundant, and kept for parity with the config file.
DEFAULT_THINKING_TAGS = list(_BASE_THINKING_TAGS) + ["Thought"]

DEFAULT_AGGREGATE_PROMPT = (
    "You have received the following responses regarding the user's query:\n\n"
    "{intermediate_results}\n\n"
    "Synthesize these responses into a single, comprehensive answer that captures\n"
    "the best information and insights from all sources. Resolve any contradictions\n"
    "and provide a coherent, unified response."
)


@dataclass
class BackendSpec:
    """One entry of ``primary_backends``. ``retries`` (default 0) applies to
    ``http(s)://`` relays only: extra attempts of a call on connect errors
    and upstream 5xx, never past the request's deadline."""

    name: str
    url: str
    model: str = ""
    retries: int = 0

    @property
    def is_valid(self) -> bool:
        return bool(self.url)

    @property
    def scheme(self) -> str:
        return urlparse(self.url).scheme.lower()

    @property
    def model_id(self) -> str:
        """``cuda://llama-3-8b?slots=4`` → ``llama-3-8b``."""
        p = urlparse(self.url)
        return (p.netloc + p.path).strip("/")

    @property
    def options(self) -> dict[str, str]:
        return dict(parse_qsl(urlparse(self.url).query))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "BackendSpec":
        try:
            retries = int(d.get("retries", 0) or 0)
        except (TypeError, ValueError):
            logger.warning("backend %r: invalid retries=%r ignored", d.get("name"),
                           d.get("retries"))
            retries = 0
        return cls(name=str(d.get("name", "")), url=str(d.get("url", "") or ""),
                   model=str(d.get("model", "") or ""), retries=max(0, retries))


@dataclass
class ConcatenateParams:
    """The ``strategy.concatenate`` block."""

    separator: str = "\n-------------\n"
    hide_intermediate_think: bool = True
    hide_final_think: bool = False
    thinking_tags: list[str] = field(default_factory=lambda: list(DEFAULT_THINKING_TAGS))
    skip_final_aggregation: bool = False

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ConcatenateParams":
        p = cls()
        p.separator = d.get("separator", p.separator)
        p.hide_intermediate_think = bool(d.get("hide_intermediate_think",
                                               p.hide_intermediate_think))
        p.hide_final_think = bool(d.get("hide_final_think", p.hide_final_think))
        p.thinking_tags = list(d.get("thinking_tags") or p.thinking_tags)
        p.skip_final_aggregation = bool(d.get("skip_final_aggregation",
                                              p.skip_final_aggregation))
        return p


@dataclass
class AggregateParams:
    """The ``strategy.aggregate`` block. ``source_backends`` picks the
    members fanned out to; ``aggregator_priority`` rides the aggregation
    hop's body (engines with QoS classes read it, others ignore it);
    ``stream_aggregate`` relays the aggregator's tokens as they decode;
    ``speculative_aggregation`` asserts at boot that the aggregator runs
    speculative decoding."""

    source_backends: list[str] | str = "all"
    aggregator_backend: str = ""
    intermediate_separator: str = "\n\n---\n\n"
    include_source_names: bool = False
    source_label_format: str = "Response from {backend_name}:\n"
    prompt_template: str = DEFAULT_AGGREGATE_PROMPT
    strip_intermediate_thinking: bool = True
    hide_aggregator_thinking: bool = True
    thinking_tags: list[str] = field(default_factory=lambda: list(DEFAULT_THINKING_TAGS))
    include_original_query: bool = True
    query_format: str = "Original query: {query}\n\n"
    suppress_individual_responses: bool = False
    aggregator_priority: str = "interactive"
    stream_aggregate: bool = False
    speculative_aggregation: bool = False

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AggregateParams":
        p = cls()
        p.source_backends = d.get("source_backends", p.source_backends)
        p.aggregator_backend = d.get("aggregator_backend", p.aggregator_backend) or ""
        p.intermediate_separator = d.get("intermediate_separator", p.intermediate_separator)
        p.include_source_names = bool(d.get("include_source_names", p.include_source_names))
        p.source_label_format = d.get("source_label_format", p.source_label_format)
        p.prompt_template = d.get("prompt_template", p.prompt_template)
        p.strip_intermediate_thinking = bool(d.get("strip_intermediate_thinking",
                                                   p.strip_intermediate_thinking))
        p.hide_aggregator_thinking = bool(d.get("hide_aggregator_thinking",
                                                p.hide_aggregator_thinking))
        p.thinking_tags = list(d.get("thinking_tags") or p.thinking_tags)
        p.include_original_query = bool(d.get("include_original_query",
                                              p.include_original_query))
        p.query_format = d.get("query_format", p.query_format)
        p.suppress_individual_responses = bool(d.get("suppress_individual_responses",
                                                     p.suppress_individual_responses))
        prio = d.get("aggregator_priority", p.aggregator_priority)
        if prio not in ("", "interactive", "batch", "background"):
            raise ValueError(f"invalid aggregator_priority {prio!r} (interactive, batch, "
                             "background, or \"\" to send no priority knob)")
        p.aggregator_priority = prio
        p.stream_aggregate = bool(d.get("stream_aggregate", p.stream_aggregate))
        p.speculative_aggregation = bool(d.get("speculative_aggregation",
                                               p.speculative_aggregation))
        return p


@dataclass
class Config:
    raw: dict[str, Any]
    # The file it was loaded from (None for a dict config): what a reload
    # watches.
    source_path: Path | None = None

    @property
    def backends(self) -> list[BackendSpec]:
        return [BackendSpec.from_dict(b) for b in self.raw.get("primary_backends") or []]

    @property
    def valid_backends(self) -> list[BackendSpec]:
        return [b for b in self.backends if b.is_valid]

    @property
    def timeout(self) -> float:
        return float((self.raw.get("settings") or {}).get("timeout", 60) or 60)

    @property
    def strategy_name(self) -> str:
        """``iterations.aggregation.strategy`` (``or {}``: a YAML section
        present with its children commented out parses to None)."""
        return (((self.raw.get("iterations") or {}).get("aggregation") or {})
                .get("strategy", "concatenate"))

    @property
    def has_strategy_config(self) -> bool:
        return "iterations" in self.raw and "strategy" in self.raw

    def parallel_enabled(self, n_valid_backends: int | None = None) -> bool:
        """Parallel mode: a strategy config and more than one backend."""
        n = len(self.valid_backends) if n_valid_backends is None else n_valid_backends
        return self.has_strategy_config and n > 1

    @property
    def concatenate(self) -> ConcatenateParams:
        return ConcatenateParams.from_dict((self.raw.get("strategy") or {})
                                           .get("concatenate") or {})

    @property
    def aggregate(self) -> AggregateParams:
        return AggregateParams.from_dict((self.raw.get("strategy") or {})
                                         .get("aggregate") or {})


def load_config(path: str | os.PathLike | None = None) -> Config:
    """Load a YAML config: ``path``, else ``$QUORUM_TPU_CONFIG``, else
    ``config.yaml`` in the working directory. A missing or unreadable file
    falls back to :data:`DEFAULT_CONFIG` (no backends)."""
    import yaml  # lazy: only file-backed configs need it

    cand = Path(path or os.environ.get("QUORUM_TPU_CONFIG") or Path.cwd() / "config.yaml")
    try:
        raw = yaml.safe_load(cand.read_text())
    except (OSError, yaml.YAMLError) as e:
        logger.warning("could not load config from %s (%s); using the default", cand, e)
        return Config(raw=copy.deepcopy(DEFAULT_CONFIG))
    if not isinstance(raw, dict):
        raise ValueError(f"config root must be a mapping, got {type(raw).__name__}")
    return Config(raw=raw, source_path=cand)
