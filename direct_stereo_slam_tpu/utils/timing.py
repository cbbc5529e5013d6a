"""Per-stage timing instrumentation.

Equivalent of the reference's hand-rolled ``TimeVector`` + ``print_average``
(main.cpp:31-40, 181-201; LoopHandler.h:131-139): named vectors of
wall-clock spans, averaged and printed at shutdown with the same stage
names so timing tables are comparable side-by-side.

Two aids for profiling on an async-dispatch device:

- ``sync=True`` puts a device barrier at every span exit, so each stage's
  wall-clock includes the device work it enqueued instead of letting it
  drain inside whichever later stage blocks first (without it a stage
  that only dispatches reads as nearly free while its device time is
  billed to the next stage that pulls). The barrier is a trivial jitted
  program that completes only after everything enqueued before it on the
  device's stream; run ``barrier_overhead_ms()`` to calibrate and
  subtract its cost.
- ``instrument_pulls()`` wraps ``jax.device_get`` to count blocking host
  pulls and their wall time per active span.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

_BARRIER_FN = None


def _device_barrier():
    """Block until all device work enqueued so far has completed."""
    global _BARRIER_FN
    if _BARRIER_FN is None:
        import jax
        import jax.numpy as jnp
        _BARRIER_FN = jax.jit(lambda: jnp.zeros(()))
    _BARRIER_FN().block_until_ready()


def barrier_overhead_ms(n: int = 5) -> float:
    """Median cost of a back-to-back barrier (dispatch + one host sync):
    the per-span overhead sync mode adds."""
    _device_barrier()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        _device_barrier()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return 1000.0 * samples[len(samples) // 2]


class StageTimers:
    def __init__(self, sync: bool = False):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.pull_s: Dict[str, float] = defaultdict(float)
        self.pull_n: Dict[str, int] = defaultdict(int)
        self.sync = sync
        self._stack: List[str] = []

    @contextmanager
    def span(self, name: str):
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _device_barrier()
            self.times[name].append(time.perf_counter() - t0)
            self._stack.pop()

    def add(self, name: str, seconds: float):
        self.times[name].append(seconds)

    def record_pull(self, seconds: float):
        """Bill a blocking host pull to the innermost active span."""
        name = self._stack[-1] if self._stack else "(no span)"
        self.pull_s[name] += seconds
        self.pull_n[name] += 1

    def average_ms(self, name: str) -> float:
        v = self.times.get(name, [])
        return 1000.0 * sum(v) / len(v) if v else 0.0

    def count(self, name: str) -> int:
        return len(self.times.get(name, []))

    def pull_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-span blocking-pull bill: {span: {n, ms, ms_per_event}}."""
        out = {}
        for name, n in self.pull_n.items():
            events = max(self.count(name), 1)
            out[name] = {
                "n": n,
                "ms": round(1000.0 * self.pull_s[name], 3),
                "n_per_event": round(n / events, 2),
                "ms_per_event": round(1000.0 * self.pull_s[name] / events, 3),
            }
        return out

    def report(self, names=None) -> str:
        names = names or sorted(self.times)
        lines = []
        for n in names:
            line = f"{n}: {self.average_ms(n):.2f}ms x {self.count(n)}"
            if self.pull_n.get(n):
                line += (f"  [pulls: {self.pull_n[n]}, "
                         f"{1000.0 * self.pull_s[n]:.1f}ms]")
            lines.append(line)
        return "\n".join(lines)


@contextmanager
def instrument_pulls(*timers: StageTimers):
    """Wrap jax.device_get so every blocking host pull is counted and its
    wall time billed to the innermost active span of whichever timer has
    one (frontend and loop handler keep separate span stacks)."""
    import jax

    orig = jax.device_get

    def wrapped(x):
        t0 = time.perf_counter()
        try:
            return orig(x)
        finally:
            dt = time.perf_counter() - t0
            for tm in timers:
                if tm._stack:
                    tm.record_pull(dt)
                    break
            else:
                if timers:
                    timers[0].record_pull(dt)

    jax.device_get = wrapped
    try:
        yield
    finally:
        jax.device_get = orig
