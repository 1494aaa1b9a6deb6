"""Launch counts of the kernel wrappers that run inside CUDA graphs (K2 and
K2q8): each wrapper calls :func:`count` with itself where it launches its
kernel. An eager call adds one to ``wrapper.launches``; a call made while
its thread captures a graph (:func:`capturing`) counts as captured, and
``engine/graphs.py`` adds a graph's captured calls on every replay
(:func:`add_launches`). Exact under concurrent callers (one lock).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

_LOCK = threading.Lock()
_CAPTURE = threading.local()  # .on: this thread is capturing; .n: calls it captured


def count(wrapper: Callable) -> None:
    """One launch by ``wrapper``: counted on ``wrapper.launches``, or as
    one captured call while this thread captures a graph."""
    if getattr(_CAPTURE, "on", False):
        counts = _CAPTURE.__dict__.setdefault("n", {})
        counts[wrapper] = counts.get(wrapper, 0) + 1
        return
    add_launches({wrapper: 1})


@contextlib.contextmanager
def capturing():
    """Mark this thread as capturing a CUDA graph: its calls count as
    captured, not launched."""
    _CAPTURE.on = True
    try:
        yield
    finally:
        _CAPTURE.on = False


def captured_launches() -> dict:
    """Calls this thread has captured into CUDA graphs so far, by wrapper."""
    return dict(getattr(_CAPTURE, "n", {}))


def add_launches(counts: dict) -> None:
    """Count launches by wrapper: a graph replay adds the calls it captured."""
    with _LOCK:
        for wrapper, n in counts.items():
            wrapper.launches += n
