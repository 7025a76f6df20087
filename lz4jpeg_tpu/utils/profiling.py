"""Profiling and device timing.

The reference's only "profiler" is ``clock()`` around child processes
(``Experiment/LZ4_sequential_experiment.c:99-116``).  The device
equivalents (SURVEY.md §5): ``jax.profiler`` traces for kernel-level
inspection, and a wall-clock timer around work that ends in
``jax.block_until_ready`` — JAX dispatch is asynchronous, so a timer that
does not wait for the device measures only the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, List


def fenced(fn: Callable) -> Callable:
    """Jit ``fn``; calling the result returns its outputs once the device
    has finished computing them."""
    import jax

    jitted = jax.jit(fn)
    return lambda *args: jax.block_until_ready(jitted(*args))


def time_device(
    fn: Callable, *args, runs: int = 10, warmup: int = 2
) -> List[float]:
    """Per-run wall times of a device computation (warm-up calls, which
    include compilation, are not timed)."""
    f = fenced(fn)
    for _ in range(warmup):
        f(*args)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        f(*args)
        times.append(time.perf_counter() - t0)
    return times


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """``jax.profiler`` trace scope; view with TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
