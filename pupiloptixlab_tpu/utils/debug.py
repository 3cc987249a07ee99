"""Device-value sanitizer — the analog of the reference's debug
exception machinery.

The reference compiles every OptiX pipeline with exception flags
DEBUG | TRACE_DEPTH | STACK_OVERFLOW (optix/pipeline.cpp:19) and runs
``CUDA_SYNC_CHECK`` after pre-passes (system/system.cpp:51): a *debug
build option* that validates device execution at a pipeline boundary.
There is no TSAN/ASAN analog needed under XLA (programs are data-race-free by
construction — no shared mutable state inside a jit), so the failure
class that remains is VALUE corruption: NaN/Inf radiance, non-finite
G-buffers, negative sample weights. This module compiles those checks
into the frame when ``RenderConfig.debug_checks`` is set (a static jit
companion, exactly like an OptiX pipeline compile option) and raises a
structured host-side error naming the offending stage.

Usage::

    config = dataclasses.replace(config, debug_checks=True)
    accum, bufs = render_frame(...)         # bufs["sanitizer"] present
    assert_all_finite(bufs["sanitizer"])    # raises SanitizerError

The PT pass enables it when the environment variable ``PUPIL_SANITIZE``
is non-empty (the CUDA_SYNC_CHECK-after-every-pass mode).
"""

from __future__ import annotations

import jax.numpy as jnp


class SanitizerError(RuntimeError):
    """Non-finite device values detected by the frame sanitizer."""


def _count_bad(arr: jnp.ndarray, lo: float | None = None) -> jnp.ndarray:
    """Scalar i32 count of non-finite (or < lo) elements."""
    bad = ~jnp.isfinite(arr)
    if lo is not None:
        bad = bad | (arr < lo)
    return jnp.sum(bad.astype(jnp.int32))


def finite_report(stages: dict[str, tuple[jnp.ndarray, float | None]]):
    """Build the in-jit sanitizer report: {stage: bad-element count}.

    ``stages`` maps a stage name to (array, lower-bound-or-None). The
    result is a dict of scalar i32 arrays — a handful of reductions
    fused into the frame program, so the check costs ~nothing next to
    the render itself.
    """
    return {k: _count_bad(a, lo) for k, (a, lo) in stages.items()}


def assert_all_finite(report: dict, context: str = "frame") -> None:
    """Host-side gate over a ``finite_report`` result: raises
    SanitizerError naming every stage with bad values (the
    CUDA_SYNC_CHECK moment — forces the device sync)."""
    bad = {k: int(v) for k, v in report.items() if int(v) > 0}
    if bad:
        detail = ", ".join(f"{k}: {c} bad element(s)" for k, c in bad.items())
        raise SanitizerError(f"sanitizer [{context}]: {detail}")
