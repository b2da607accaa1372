"""Tracing / profiling helpers.

The reference's only instrumentation is a wall-clock print around the
whole run (`example.py:46,67`). Here (SURVEY.md §5):

  * `trace(logdir)` — context manager around `jax.profiler` producing
    xprof/perfetto-compatible dumps (the step itself is annotated with
    `jax.named_scope("sp"/"tm")` in `models/htm.py`, so device traces
    attribute time per phase).
  * `PhaseTimer` — host-side wall-clock phase timing, for quick
    interactive numbers without a trace viewer. Dispatch is
    asynchronous: end each timed phase with `jax.block_until_ready`.
  * `require_gpu` — the device check every measurement entry point
    makes: timings come from the GPU, never from a CPU fallback.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block into `logdir` (view with xprof/tensorboard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def require_gpu(allow_cpu: bool = False):
    """Return the first JAX device after checking that it is a GPU.

    ``allow_cpu`` is an entry point's explicit ``--cpu`` flag: then the
    CPU backend is accepted. Otherwise a process with no GPU exits with
    a message instead of measuring the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not allow_cpu:
        raise SystemExit(f"no GPU found (JAX platform {dev.platform!r}); "
                         f"pass --cpu to run on the CPU backend")
    return dev


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    with timer.phase("tm_forward"):
        out = step(...)
        jax.block_until_ready(out)
    print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name}: {total * 1e3:.1f} ms total, "
                f"{total / n * 1e3:.2f} ms/call ({n} calls)"
            )
        return "\n".join(lines)
