"""Timing harness: warmup + blocked per-iteration wall-clock + stats.

Reference equivalents: per-iteration ``clock_gettime`` pairs around the hot
loop (main-cli.c:408,419), ns→ms conversion and total/avg/min/max/stdev
reduction (main-cli.c:428-456), stdev (main-cli.c:114-130 — whose
uninitialized-accumulator UB we obviously do not reproduce).

Device specifics: the first call compiles (excluded via warmup); each
timed iteration calls ``block_until_ready`` so we measure device
execution, not async dispatch. For microsecond-scale kernels an optional ``inner`` count
amortizes the host-sync overhead per timed sample.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

__all__ = [
    "TimingStats",
    "time_fn",
    "bench_spmv",
    "bench_spmv_fused",
    "bench_native_batched",
]


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Per-iteration wall-clock statistics, in milliseconds.

    Field-for-field analog of the reference ``_time_data_`` struct
    (main-cli.c:87-95).
    """

    times_ms: np.ndarray  # per-sample ms (flexible array member analog)
    iterations: int
    # Fused device-loop runs cannot observe individual iterations: each
    # sample is a per-launch average over the whole loop, so min/max/stdev
    # describe launches, not iterations. Reports label this.
    per_launch: bool = False

    @property
    def total_ms(self) -> float:
        return float(self.times_ms.sum())

    @property
    def avg_ms(self) -> float:
        return float(self.times_ms.mean())

    @property
    def min_ms(self) -> float:
        return float(self.times_ms.min())

    @property
    def max_ms(self) -> float:
        return float(self.times_ms.max())

    @property
    def stdev_ms(self) -> float:
        # Population stdev like the reference's calcStDevDouble
        # (main-cli.c:114-130), minus its UB.
        return float(self.times_ms.std())

    def nnz_per_s(self, nnz: int) -> float:
        return nnz / (self.avg_ms * 1e-3) if self.avg_ms > 0 else float("inf")

    def gb_per_s(self, bytes_per_iter: float) -> float:
        return (
            bytes_per_iter / (self.avg_ms * 1e-3) / 1e9
            if self.avg_ms > 0
            else float("inf")
        )


def time_fn(
    fn: Callable[[], object],
    *,
    iterations: int = 1000,
    warmup: int = 2,
    inner: int = 1,
    block: Optional[Callable[[object], None]] = None,
) -> TimingStats:
    """Time ``fn`` for ``iterations`` samples after ``warmup`` calls.

    ``fn`` must return a JAX array (or pytree with ``block_until_ready``) —
    each sample is bracketed host-side after blocking on the result, the
    device analog of the reference's ATOMIC SECTION (main-cli.c:396-399).
    ``inner > 1`` runs fn several times per sample and divides, for
    kernels shorter than the ~10µs host-sync floor.
    """

    def _block(res):
        if block is not None:
            block(res)
        elif hasattr(res, "block_until_ready"):
            res.block_until_ready()

    # warmup=0 is honored: the first timed sample then includes compile
    # (useful for cold-start measurement).
    for _ in range(max(warmup, 0)):
        _block(fn())

    samples: List[float] = []
    for _ in range(iterations):
        t0 = time.perf_counter_ns()
        if inner == 1:
            _block(fn())
        else:
            res = None
            for _ in range(inner):
                res = fn()
            _block(res)
        t1 = time.perf_counter_ns()
        samples.append((t1 - t0) / 1e6 / inner)
    return TimingStats(times_ms=np.asarray(samples), iterations=iterations)


def bench_spmv(
    spmv: Callable,
    matrix,
    x,
    *,
    iterations: int = 1000,
    warmup: int = 2,
    inner: int = 1,
) -> TimingStats:
    """Benchmark ``y = spmv(matrix, x)`` with fresh-y semantics.

    Matches the reference protocol: y is recomputed from scratch each
    iteration (y-reset outside the timed region, main-cli.c:405) — under
    XLA each call allocates a fresh y, so only the kernel is timed.
    """
    return time_fn(
        lambda: spmv(matrix, x),
        iterations=iterations,
        warmup=warmup,
        inner=inner,
    )


def bench_native_batched(
    op,
    x,
    *,
    iterations: int = 1000,
    repeats: int = 8,
    warmup: int = 1,
) -> TimingStats:
    """Time a native (ctypes) operator with iterations batched inside the
    C loop.

    The ~2.7 µs Python→ctypes dispatch floor dominates sub-300-nnz
    matrices when every iteration is a separate call; batching K
    iterations per launch (the native kernels accept ``iterations=``)
    measures the C hot loop itself, like the reference's in-process timed
    loop (main-cli.c:402-420).
    """
    import numpy as np  # noqa: F811 — keep module import graph lazy-safe

    xn = np.ascontiguousarray(np.asarray(x), dtype=np.float32)
    repeats = max(min(repeats, iterations), 1)
    per = iterations // repeats
    for _ in range(max(warmup, 0)):
        op(xn, iterations=max(min(per, 20), 1))

    samples = []
    left = iterations
    for i in range(repeats):
        k = per if i < repeats - 1 else left
        left -= k
        t0 = time.perf_counter_ns()
        op(xn, iterations=k)
        t1 = time.perf_counter_ns()
        samples.append((t1 - t0) / 1e6 / k)
    per_iter = np.repeat(np.asarray(samples), max(per, 1))[:iterations]
    if per_iter.size < iterations:
        per_iter = np.pad(per_iter, (0, iterations - per_iter.size),
                          mode="edge")
    return TimingStats(times_ms=per_iter, iterations=iterations,
                       per_launch=per > 1)


def bench_spmv_fused(
    spmv: Callable,
    matrix,
    x,
    *,
    iterations: int = 1000,
    repeats: int = 5,
    warmup: int = 1,
    return_final=False,
):
    """Benchmark N sequential SpMVs executed inside ONE device program.

    The reference's timed loop is N back-to-back SpMVs (main-cli.c:402-420);
    running the loop as a ``lax.fori_loop`` on device measures the same
    work without a host dispatch per iteration, so kernels shorter than
    the launch overhead are timed by their device work. The per-iteration
    x is data-dependent on the accumulator through a never-taken select,
    so XLA cannot hoist the SpMV out of the loop; numerically every
    iteration computes the same y = A·x.

    Returns per-iteration stats over ``repeats`` device-loop launches.
    With ``return_final=True`` returns ``(stats, acc)`` where ``acc`` is
    the warmup launch's accumulator — ``iterations · y``, so callers can
    correctness-gate the run against a host oracle without compiling a
    separate single-shot program.
    """
    import jax
    import jax.numpy as jnp

    # The kernel's output shape/dtype set the accumulator: a fori_loop
    # carry must keep one dtype across iterations. Works for SpMM too
    # (x/y may be (n, k) blocks).
    out = jax.eval_shape(lambda xx: spmv(matrix, xx), x)

    # The matrix is a closure constant, NOT a traced argument: SpMV
    # implementations may do host-side preparation on it (spmv_cisr
    # builds its operator with numpy), which is impossible on tracers.
    # The closed-over device arrays (hundreds of MB at scale) must then
    # be re-bound as jit PARAMETERS: captured-constant HLO would embed
    # them as dense literals in the program. jax.closure_convert does
    # NOT hoist concrete arrays (only tracers), so hoist them by hand
    # from the traced jaxpr.
    closed_jaxpr = jax.make_jaxpr(lambda xx: spmv(matrix, xx))(x)
    consts = closed_jaxpr.consts

    def closed(xx, consts):
        return jax.core.eval_jaxpr(closed_jaxpr.jaxpr, consts, xx)[0]

    @jax.jit
    def run(x, consts):
        def body(i, acc):
            # acc-dependent perturbation that is always exactly 0.0 at
            # runtime but defeats loop-invariant code motion.
            xi = x.at[0].add(
                jnp.where(i < 0, acc.reshape(-1)[0], 0.0).astype(x.dtype)
            )
            y = closed(xi, consts)
            return acc + y.astype(out.dtype)

        return jax.lax.fori_loop(
            0, iterations, body, jnp.zeros(out.shape, out.dtype)
        )

    acc = run(x, consts).block_until_ready()
    for _ in range(max(warmup, 1) - 1):
        run(x, consts).block_until_ready()

    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        run(x, consts).block_until_ready()
        t1 = time.perf_counter_ns()
        samples.append((t1 - t0) / 1e6 / iterations)

    # Expand the per-repeat loop averages to one sample per iteration so
    # TimingStats totals/extrema mean what the reference-format report
    # says they mean (Total ≈ iterations x avg; Fastest/Slowest are the
    # best/worst device-loop averages — per_launch marks them as such).
    per_iter = np.repeat(
        np.asarray(samples), -(-iterations // max(repeats, 1))
    )[:iterations]
    stats = TimingStats(times_ms=per_iter, iterations=iterations,
                        per_launch=True)
    return (stats, acc) if return_final else stats
