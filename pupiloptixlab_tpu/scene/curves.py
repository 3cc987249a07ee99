"""Round-curve basis evaluation — the builtin curve-module set.

The reference ships four OptiX builtin round-curve intersection modules
(reference: framework/optix/module.h:20-29): ROUND_LINEAR,
ROUND_QUADRATIC_BSPLINE, ROUND_CUBIC_BSPLINE and ROUND_CATMULLROM. No
hardware curve intersector is used here; instead every basis
evaluates here (host-side, flatten time) to a polyline of rounded-cone
segments that the analytic intersector handles
(accel/intersect.py::_curve_tests). The radius channel rides the same
basis as the position, matching the OptiX builtin IS semantics where
each control vertex is (x, y, z, w=radius).

Segment-window semantics match OptiX: a spline with P control vertices
has P-2 quadratic or P-3 cubic spans; Catmull-Rom spans interpolate the
interior points p1..p_{P-2} with NO phantom end duplication (a segment
needs its full 4-cv window, exactly like the hardware primitive).
"""

from __future__ import annotations

import numpy as np

BASES = ("linear", "bspline2", "bspline3", "catmullrom")


def _span_windows(pts: np.ndarray, order: int) -> np.ndarray:
    """(P, 4) -> (spans, order, 4) sliding windows of control vertices."""
    spans = pts.shape[0] - order + 1
    return np.stack([pts[i : i + spans] for i in range(order)], axis=1)


def _eval_spans(win: np.ndarray, coeff_fn, subdiv: int) -> np.ndarray:
    """Evaluate each span at subdiv+1 parameters and join shared span
    endpoints (all supported bases are at least C0 across spans)."""
    t = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    w = coeff_fn(t)  # (order, subdiv+1)
    # (spans, order, 4) x (order, S) -> (spans, S, 4)
    pts = np.einsum("sow,ot->stw", win, w.astype(np.float32))
    first = pts[0, :1]
    rest = pts[:, 1:].reshape(-1, 4)
    return np.concatenate([first, rest], axis=0).astype(np.float32)


def _quadratic_bspline_coeffs(t: np.ndarray) -> np.ndarray:
    """Uniform quadratic B-spline basis (approximating, C1)."""
    return np.stack([
        0.5 * (1.0 - t) ** 2,
        0.5 * (-2.0 * t * t + 2.0 * t + 1.0),
        0.5 * t * t,
    ])


def _cubic_bspline_coeffs(t: np.ndarray) -> np.ndarray:
    """Uniform cubic B-spline basis (approximating, C2)."""
    t2, t3 = t * t, t * t * t
    return np.stack([
        (1.0 - t) ** 3 / 6.0,
        (3.0 * t3 - 6.0 * t2 + 4.0) / 6.0,
        (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0) / 6.0,
        t3 / 6.0,
    ])


def _catmullrom_coeffs(t: np.ndarray) -> np.ndarray:
    """Uniform Catmull-Rom basis (interpolates p1 at t=0, p2 at t=1)."""
    t2, t3 = t * t, t * t * t
    return 0.5 * np.stack([
        -t3 + 2.0 * t2 - t,
        3.0 * t3 - 5.0 * t2 + 2.0,
        -3.0 * t3 + 4.0 * t2 + t,
        t3 - t2,
    ])


def basis_for(shape_type: str, degree: int | None) -> str:
    """XML shape type (+ optional degree attribute) -> basis name.

    ``linearcurve`` -> linear; ``bsplinecurve`` -> cubic unless
    degree=2; ``catmullromcurve`` -> catmullrom (the 4th builtin)."""
    if shape_type == "linearcurve":
        return "linear"
    if shape_type == "catmullromcurve":
        return "catmullrom"
    return "bspline2" if degree == 2 else "bspline3"


def min_points(basis: str) -> int:
    return {"linear": 2, "bspline2": 3, "bspline3": 4, "catmullrom": 4}[basis]


def tessellate(pts: np.ndarray, basis: str, subdiv: int = 8) -> np.ndarray:
    """Control vertices (P, 4) [x y z r] -> polyline (M, 4) whose
    consecutive pairs become rounded-cone segments.

    ``subdiv`` rounded cones approximate each span; the tessellation
    converges to the exact swept-sphere curve as subdiv grows (gated by
    tests/test_curves.py against a dense reference tessellation)."""
    pts = np.ascontiguousarray(np.asarray(pts, np.float32))
    if basis not in BASES:
        raise ValueError(f"unknown curve basis {basis!r}")
    if basis == "linear" or pts.shape[0] < min_points(basis):
        return pts
    if basis == "bspline2":
        return _eval_spans(
            _span_windows(pts, 3), _quadratic_bspline_coeffs, subdiv
        )
    if basis == "bspline3":
        return _eval_spans(
            _span_windows(pts, 4), _cubic_bspline_coeffs, subdiv
        )
    return _eval_spans(_span_windows(pts, 4), _catmullrom_coeffs, subdiv)
