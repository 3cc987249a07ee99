"""Hero-wavelength spectral rendering — beyond the reference.

The reference is an RGB renderer throughout (float3 radiance end to
end, example/path_tracer/main.cu). This module upgrades the integrator
to SPECTRAL transport with C = 4 wavelengths per path (hero + 3
rotated strata, Wilkie et al. 2014 "Hero Wavelength Spectral
Sampling"), enabling physically-based dispersion (rainbow caustics
through glass) that an RGB renderer cannot express.

Design: wavelengths are 4 extra (N,) planes (``Spec4`` — same
structure-of-planes layout as Vec3); every spectral op is elementwise
work fused into the frame program. No tables are fetched per lane:

* CIE 1931 color-matching functions use the Wyman-Sloan-Shirley
  piecewise-Gaussian analytic fits (JCGT 2013) — pure arithmetic.
* RGB reflectances/radiances lift to spectra through a smooth
  PARTITION-OF-UNITY basis (three smoothstep bands) calibrated at
  import time by a 3x3 inverse so that
    - rgb -> spectrum -> rgb is EXACT for in-gamut colors, and
    - rgb (1,1,1) lifts to the constant-1 spectrum (white furnaces and
      energy tests hold exactly; the equal-energy-white convention).
  This is the Mallett-Yuksel 2019 construction with an analytic basis.
* the estimator integrates against the CMFs by Monte Carlo over the
  path's 4 wavelengths (uniform pdf, stratified): in expectation
  rgb_out = M_int(S) with zero extra bias.

Dispersion: dielectrics take a Cauchy coefficient (XML ``dispersion``
in um^2, or an Abbe number ``abbe``); eta(lambda) = eta_d +
B (1/lambda^2 - 1/lambda_d^2). Path geometry follows the HERO
wavelength; on the first dispersive transmission the 3 secondary
wavelengths terminate (throughput collapses to the hero, scaled by C —
the standard hero-wavelength MIS collapse).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from pupiloptixlab_tpu.render.vec import Vec3

SPECTRAL_SAMPLES = 4
LAM_MIN, LAM_MAX = 380.0, 780.0
LAM_RANGE = LAM_MAX - LAM_MIN
LAM_D = 587.6  # Fraunhofer d line (nm): the anchor of eta(lambda)
LAM_F, LAM_C = 486.13, 656.28  # F / C lines (Abbe number definition)


class Spec4(NamedTuple):
    """Four spectral samples as dense (N,) planes (cf. Vec3)."""

    s0: jnp.ndarray  # hero
    s1: jnp.ndarray
    s2: jnp.ndarray
    s3: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, Spec4):
            return Spec4(*(a + b for a, b in zip(self, o)))
        return Spec4(*(a + o for a in self))

    def __mul__(self, o):
        if isinstance(o, Spec4):
            return Spec4(*(a * b for a, b in zip(self, o)))
        return Spec4(*(a * o for a in self))

    __rmul__ = __mul__

    @staticmethod
    def zeros(n: int) -> "Spec4":
        z = jnp.zeros(n, jnp.float32)
        return Spec4(z, z, z, z)

    @staticmethod
    def ones(n: int) -> "Spec4":
        o = jnp.ones(n, jnp.float32)
        return Spec4(o, o, o, o)

    def mean(self):
        return 0.25 * (self.s0 + self.s1 + self.s2 + self.s3)


# -- CIE 1931 CMFs: Wyman, Sloan, Shirley (JCGT 2013) multi-Gaussian fits ----


def _pg(lam, mu, s1, s2):
    """Piecewise Gaussian: sigma = s1 below mu, s2 above."""
    s = jnp.where(lam < mu, s1, s2)
    t = (lam - mu) / s
    return jnp.exp(-0.5 * t * t)


def cie_x(lam):
    return (
        1.056 * _pg(lam, 599.8, 37.9, 31.0)
        + 0.362 * _pg(lam, 442.0, 16.0, 26.7)
        - 0.065 * _pg(lam, 501.1, 20.4, 26.2)
    )


def cie_y(lam):
    return 0.821 * _pg(lam, 568.8, 46.9, 40.5) + 0.286 * _pg(
        lam, 530.9, 16.3, 31.1
    )


def cie_z(lam):
    return 1.217 * _pg(lam, 437.0, 11.8, 36.0) + 0.681 * _pg(
        lam, 459.0, 26.0, 13.8
    )


# XYZ -> linear sRGB (IEC 61966-2-1)
_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float64,
)


def _smoothstep(x, a, b):
    t = jnp.clip((x - a) / (b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# Band edges of the partition-of-unity reflectance basis. Chosen near
# the blue-green / green-red CMF crossovers; the 3x3 calibration below
# absorbs the exact placement.
_EDGE_BG = (460.0, 520.0)
_EDGE_GR = (555.0, 625.0)


def _basis(lam):
    """Partition-of-unity smoothstep bands: returns (b_r, b_g, b_b),
    b_r + b_g + b_b == 1 for every lambda."""
    t_bg = _smoothstep(lam, *_EDGE_BG)
    t_gr = _smoothstep(lam, *_EDGE_GR)
    return t_gr, t_bg - t_gr, 1.0 - t_bg


def _calibrate():
    """Import-time quadrature (numpy, static constants baked into jit):

    * D: per-channel scale making the constant-1 spectrum map to sRGB
      (1,1,1) (equal-energy white convention),
    * M[c, b] = integral of rgbw_c(lambda) * basis_b(lambda): the
      basis -> rgb matrix. Rows of M sum to 1 by construction.
    * C = M^-1: the rgb -> basis-coefficient matrix; C @ (1,1,1) =
      (1,1,1), so white lifts to the constant-1 spectrum exactly.
    """
    # numpy-only (the module may first import INSIDE a jit trace, where
    # omnistaging would turn any jnp op into a tracer)
    lam = np.linspace(LAM_MIN, LAM_MAX, 2001)

    def pg(mu, s1, s2):
        s = np.where(lam < mu, s1, s2)
        return np.exp(-0.5 * ((lam - mu) / s) ** 2)

    cmf = np.stack([
        1.056 * pg(599.8, 37.9, 31.0) + 0.362 * pg(442.0, 16.0, 26.7)
        - 0.065 * pg(501.1, 20.4, 26.2),
        0.821 * pg(568.8, 46.9, 40.5) + 0.286 * pg(530.9, 16.3, 31.1),
        1.217 * pg(437.0, 11.8, 36.0) + 0.681 * pg(459.0, 26.0, 13.8),
    ])  # (3, L)
    rgbw_raw = _XYZ_TO_SRGB @ cmf  # (3, L)
    scale = np.trapezoid(rgbw_raw, lam, axis=1)  # rgb of the unit spectrum
    d = 1.0 / scale
    rgbw = rgbw_raw * d[:, None]

    def ss(a, b):
        t = np.clip((lam - a) / (b - a), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    t_bg, t_gr = ss(*_EDGE_BG), ss(*_EDGE_GR)
    b = np.stack([t_gr, t_bg - t_gr, 1.0 - t_bg])  # (3, L)
    m = np.stack(
        [np.trapezoid(rgbw * b[j][None, :], lam, axis=1) for j in range(3)],
        axis=1,
    )  # (3 rgb, 3 basis)
    c = np.linalg.inv(m)
    return (
        tuple(float(x) for x in d),
        tuple(tuple(float(x) for x in row) for row in m),
        tuple(tuple(float(x) for x in row) for row in c),
    )


_D_SCALE, _M_BASIS, _C_RGB = _calibrate()


# Visible-wavelength importance sampling: p(lambda) proportional to
# sech^2(A (lambda - MU)) — a smooth envelope of photopic sensitivity
# (the pbrt-v4 "visible wavelengths" pdf). Sampling the sensor's
# integrand's envelope instead of uniform cuts the chroma noise of the
# wavelength MC by ~3x on white scenes. The normalization over
# [LAM_MIN, LAM_MAX] is computed in closed form at import time.
_VIS_A, _VIS_MU = 0.0072, 538.5
_VIS_T0 = float(np.tanh(_VIS_A * (LAM_MIN - _VIS_MU)))
_VIS_T1 = float(np.tanh(_VIS_A * (LAM_MAX - _VIS_MU)))
# integral of sech^2(A(l-mu)) dl = tanh(A(l-mu))/A
_VIS_NORM = (_VIS_T1 - _VIS_T0) / _VIS_A


def wavelength_pdf(lam: jnp.ndarray) -> jnp.ndarray:
    c = jnp.cosh(_VIS_A * (lam - _VIS_MU))
    return 1.0 / (_VIS_NORM * c * c)


def sample_wavelengths(u: jnp.ndarray) -> Spec4:
    """One uniform draw -> 4 stratified wavelengths (nm): the hero plus
    3 equal rotations, warped through the visible-importance CDF
    (each marginally p = wavelength_pdf)."""
    def lam(j):
        f = u + j / SPECTRAL_SAMPLES
        f = f - jnp.floor(f)
        t = _VIS_T0 + (_VIS_T1 - _VIS_T0) * f
        return _VIS_MU + jnp.arctanh(t) / _VIS_A

    return Spec4(lam(0), lam(1), lam(2), lam(3))


def lift(rgb: Vec3, lams: Spec4) -> Spec4:
    """rgb -> spectrum evaluated at the path's wavelengths:
    S(lambda) = max(sum_c (C rgb)_c basis_c(lambda), 0). Exact round
    trip in gamut; negative lobes of out-of-gamut colors clamp."""
    c = _C_RGB
    kr = c[0][0] * rgb.x + c[0][1] * rgb.y + c[0][2] * rgb.z
    kg = c[1][0] * rgb.x + c[1][1] * rgb.y + c[1][2] * rgb.z
    kb = c[2][0] * rgb.x + c[2][1] * rgb.y + c[2][2] * rgb.z

    def at(lam):
        br, bg, bb = _basis(lam)
        return jnp.maximum(kr * br + kg * bg + kb * bb, 0.0)

    return Spec4(*(at(l) for l in lams))


def to_rgb(spec: Spec4, lams: Spec4) -> Vec3:
    """Monte-Carlo CMF integration over the 4 path wavelengths:
    rgb = mean_j S_j * rgbw(lambda_j) / p(lambda_j)."""
    d = _D_SCALE
    acc = [0.0, 0.0, 0.0]
    for s, lam in zip(spec, lams):
        x, y, z = cie_x(lam), cie_y(lam), cie_z(lam)
        sp = s / wavelength_pdf(lam)
        for c in range(3):
            m = _XYZ_TO_SRGB[c]
            acc[c] = acc[c] + sp * (
                d[c] * (m[0] * x + m[1] * y + m[2] * z)
            )
    w = 1.0 / SPECTRAL_SAMPLES
    return Vec3(acc[0] * w, acc[1] * w, acc[2] * w)


def abbe_to_cauchy(n_d: float, v_d: float) -> float:
    """Abbe number -> Cauchy B (um^2): B = (n_d - 1) / (V_d (1/l_F^2 -
    1/l_C^2)), Fraunhofer lines in um."""
    lf, lc = LAM_F * 1e-3, LAM_C * 1e-3
    return (n_d - 1.0) / (max(v_d, 1e-6) * (1.0 / lf**2 - 1.0 / lc**2))


def eta_at(eta_d: jnp.ndarray, cauchy_b: jnp.ndarray, lam_nm: jnp.ndarray):
    """Cauchy dispersion on the ior RATIO, anchored at the d line:
    eta(lambda) = eta_d + B (1/lambda^2 - 1/lambda_d^2), lambda in um."""
    lam = lam_nm * 1e-3
    ld = LAM_D * 1e-3
    return eta_d + cauchy_b * (1.0 / (lam * lam) - 1.0 / (ld * ld))
