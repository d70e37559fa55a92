"""Stage tracing: wall-clock timers, throughput counters, peak RSS, and
optional JAX profiler capture.

The reference's observability is stage prints + a per-100k-reads progress
line + peak RSS (/root/reference/phaser/phaser.py:161-175, 2354-2356,
read_variant_map.py:120-123).  This module structures the same signals:
every pipeline stage records wall time and item counts; a run summary
reports reads/s per stage.  Set PHASER_TPU_PROFILE_DIR to also capture a
JAX profiler trace for the device stages.
"""

from __future__ import annotations

import contextlib
import os
import resource
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# process-wide device-path time: seconds spent preparing/launching device
# programs, waiting on them, and fetching their results (mapper.dispatch,
# engine.connections, engine.blocks all report here). Tracer snapshots this
# around a run so the summary can state what fraction of wall-clock the
# device path consumed under --device auto/gpu.
_DEVICE_SECONDS = 0.0
# process-wide count of device launches whose work was redone on the host
# (mapper.dispatch: packed-hit capacity overflow, oversized tables;
# engine.connections: pair-buffer overflow) — a run asked to use the device
# can see that it did not, in full
_DEVICE_FALLBACKS = 0
_DEVICE_LOCK = threading.Lock()
_tls = threading.local()


def add_device_time(seconds: float) -> None:
    global _DEVICE_SECONDS
    with _DEVICE_LOCK:
        _DEVICE_SECONDS += seconds
    _tls.seconds = getattr(_tls, "seconds", 0.0) + seconds


def device_seconds() -> float:
    return _DEVICE_SECONDS


def count_device_fallback() -> None:
    global _DEVICE_FALLBACKS
    with _DEVICE_LOCK:
        _DEVICE_FALLBACKS += 1


def device_fallbacks() -> int:
    return _DEVICE_FALLBACKS


def thread_device_seconds() -> float:
    """Device-path seconds accumulated by THIS thread — the per-shard
    number when shard engines run on threads (each engine's device
    launch/wait/fetch all happen on its own thread under --device auto)."""
    return getattr(_tls, "seconds", 0.0)


@contextlib.contextmanager
def device_section():
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_device_time(time.perf_counter() - t0)


@dataclass
class StageStat:
    name: str
    seconds: float = 0.0
    items: int = 0
    unit: str = "items"

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


@dataclass
class Tracer:
    stats: Dict[str, StageStat] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)
    _profiling: bool = False
    _t0: float = 0.0
    _dev0: float = 0.0
    _fb0: int = 0

    def __post_init__(self):
        self._t0 = time.perf_counter()
        self._dev0 = thread_device_seconds()
        self._fb0 = device_fallbacks()
        prof_dir = os.environ.get("PHASER_TPU_PROFILE_DIR")
        if prof_dir:
            try:
                import jax
                jax.profiler.start_trace(prof_dir)
                self._profiling = True
            except Exception:
                pass

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items"):
        from .failures import failure_stage
        if name not in self.stats:
            self.stats[name] = StageStat(name, unit=unit)
            self.order.append(name)
        st = self.stats[name]
        t0 = time.perf_counter()
        try:
            with failure_stage(name):
                yield st
        finally:
            st.seconds += time.perf_counter() - t0

    def add(self, name: str, items: int, unit: str = "items") -> None:
        if name not in self.stats:
            self.stats[name] = StageStat(name, unit=unit)
            self.order.append(name)
        self.stats[name].items += items

    def peak_rss_mb(self) -> float:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

    def device_share(self) -> tuple:
        """(device_path_seconds, wall_seconds) since this tracer started —
        device seconds are THREAD-scoped, so concurrent shard engines each
        report only their own device time."""
        return (thread_device_seconds() - self._dev0,
                time.perf_counter() - self._t0)

    def summary_lines(self) -> List[str]:
        out = ["     --- stage timings ---"]
        for name in self.order:
            st = self.stats[name]
            line = "     %-28s %8.3fs" % (name, st.seconds)
            if st.items:
                line += "  %12d %s (%.0f/s)" % (st.items, st.unit, st.rate)
            out.append(line)
        dev, wall = self.device_share()
        out.append("     device path: %.3fs of %.3fs wall (%.1f%%)"
                   % (dev, wall, 100.0 * dev / wall if wall > 0 else 0.0))
        out.append("     device fallbacks to host: %d"
                   % (device_fallbacks() - self._fb0))
        out.append("     peak RSS: %.1f MB" % self.peak_rss_mb())
        return out

    def finish(self) -> None:
        if self._profiling:
            try:
                import jax
                jax.profiler.stop_trace()
            except Exception:
                pass
