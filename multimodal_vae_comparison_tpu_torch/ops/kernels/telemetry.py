"""Dispatch and launch telemetry for the port's kernels.

Counterpart of ``ops/pallas/telemetry.py``.  Every kernel wrapper records
which path it took (``"cuda"`` for a launch, ``"plain"`` for the plain
PyTorch version on a CPU tensor) through :func:`record`, and adds one to
its launch count, and only there, right where it launches its kernel.  A
run that resets the counts, drives a path and reads them afterwards shows
which kernels that path really went through.
"""
from __future__ import annotations

import sys
import threading
from collections import Counter

_lock = threading.Lock()
_counts: Counter = Counter()
_launches: Counter = Counter()


def record(kernel: str, path: str) -> None:
    """Count a dispatch decision; print each distinct one once (stderr)."""
    key = f"{kernel}:{path}"
    with _lock:
        _counts[key] += 1
        first = _counts[key] == 1
    if first:
        print(f"[kernels] {kernel} -> {path} path", file=sys.stderr)


def count_launch(kernel: str) -> None:
    """Add one launch of ``kernel``; called by its wrapper at the launch."""
    with _lock:
        _launches[kernel] += 1


def launches() -> dict:
    """{kernel -> launches since the last reset}."""
    with _lock:
        return dict(_launches)


def summary() -> dict:
    """{kernel:path -> dispatch count since the last reset}."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
        _launches.clear()
