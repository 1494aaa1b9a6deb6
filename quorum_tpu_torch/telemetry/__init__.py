"""The port's telemetry package: the flight recorder (``recorder``), the
per-family device-time model (``latency``), SLO accounting (``slo``), W3C
trace context (``tracecontext``) and the Prometheus primitives
(``metrics``). Copies of the JAX package's modules of the same names, with
the same environment variables and family names."""

from quorum_tpu_torch.telemetry.latency import LatencyModel
from quorum_tpu_torch.telemetry.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    validate_exposition,
)
from quorum_tpu_torch.telemetry.recorder import RECORDER, FlightRecorder
from quorum_tpu_torch.telemetry.slo import SLO, SloTracker, classify

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LatencyModel",
    "MetricsRegistry",
    "RECORDER",
    "SLO",
    "SloTracker",
    "classify",
    "validate_exposition",
]
