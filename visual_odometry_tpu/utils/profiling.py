"""Tracing / profiling utilities.

The reference's only instrumentation is a ms wall clock wrapped around the
DA step (``getTime``, utils.cpp:2-6; vo_daKnown.cpp:127-138 logging to
``time_known.txt``). This module supersedes it with:

  * :class:`StageTimer` — named wall-clock stages with device
    synchronization (a fair timer for async dispatch), dumpable in the
    reference's one-number-per-line format;
  * :func:`trace` — a ``jax.profiler`` trace context writing a TensorBoard-
    compatible profile when the backend supports it (a no-op on backends
    that don't);
  * :func:`require_gpu`, :func:`card_info` and :func:`timed` — what every
    device measurement (chip_smoke.py, bench.py) starts from: a GPU or an
    error, the card's name and power limit, and first-call vs steady
    seconds ended by ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import jax


def _sync(x=None):
    if x is not None:
        jax.block_until_ready(x)


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer()
    >>> with t.stage("matching"):
    ...     result = match(...)          # noqa
    >>> t.summary()                      # {'matching': {...}}
    """

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync_on)
            self.samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_ms": 1e3 * sum(xs) / len(xs),
                "min_ms": 1e3 * min(xs),
                "max_ms": 1e3 * max(xs),
            }
        return out

    def dump(self, file_path: str, name: Optional[str] = None) -> None:
        """One duration (ms) per line — the ``time_known.txt`` contract
        (vo_daKnown.cpp:163-164)."""
        names = [name] if name else sorted(self.samples)
        with open(file_path, "w") as f:
            for n in names:
                for x in self.samples[n]:
                    f.write(f"{x * 1e3:g}\n")

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} n={s['count']:<5d} mean={s['mean_ms']:8.3f}ms "
                f"min={s['min_ms']:8.3f}ms max={s['max_ms']:8.3f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``jax.profiler`` trace context; no-op if the backend can't trace."""
    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU: a CPU timing is no device
    number, so measurements refuse to fall back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {dev.platform} devices only")
    return dev


def card_info() -> str:
    """``nvidia-smi``'s name and power limit of every card, one per line:
    a card set below its maximum power runs slower under load, so every
    number is reported beside this."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def timed(fn, reps: int = 5):
    """Run ``fn`` once (compile + run), then ``reps`` more times, each ended
    by ``jax.block_until_ready``. Returns (first-call seconds, median
    steady seconds, last result)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        steady.append(time.perf_counter() - t0)
    return first, statistics.median(steady), out
