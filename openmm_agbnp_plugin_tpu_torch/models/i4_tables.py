"""I4 descreening integral and its per-radius-pair spline lookup tables.

The AGBNP1 inverse Born radius is 1/B_i = 1/R_i - (1/4pi) sum_j s_j Q4(d_ij)
where Q4 is the analytic integral of 1/r^4 over the part of sphere j outside
sphere i.  The reference evaluates Q4 through 16-node natural cubic splines
tabulated per unique (screened-radius, screener-radius) pair and switched
smoothly to zero at 2 nm (reference: openmmapi/src/AGBNPUtils.cpp:34-214).

This module precomputes the same tables in float64 NumPy.  The pair sweeps
(ops/born.py and the CUDA kernels of ops/kernels/pairs.py) read the dense
[ntypes_i, ntypes_j, NA] arrays produced here.
"""

from __future__ import annotations

import math

import numpy as np

from .constants import (
    AGBNP_I4LOOKUP_MAXA,
    AGBNP_I4LOOKUP_NA,
    AGBNP_RADIUS_PRECISION,
    KFC,
    PFC,
    PI,
)

TWOPI = 2.0 * PI
TWOTHIRDS = 2.0 / 3.0


def i4(rij: float, Ri: float, Rj: float) -> float:
    """Analytic integral of 1/r^4 over sphere j outside sphere i.

    Three branches: separated / overlapping / included, with a removable
    singularity expansion at small rij (the same published integral the
    reference tabulates, AGBNPUtils.cpp:34-85; branch boundaries must match
    so the spline tables reproduce the reference values node-for-node).
    """
    if rij > (Ri + Rj):
        # spheres fully separated
        far = rij + Rj
        near = rij - Rj
        half_log = 0.5 * math.log(far / near)
        return TWOPI * (Rj / (far * near) - half_log / rij)
    dR = Rj - Ri
    if rij * rij > dR * dR:
        # spheres overlap: integrate from the surface of sphere i outward
        far = rij + Rj
        inv_far = 1.0 / far
        inv_Ri = 1.0 / Ri
        quad = 0.25 * (far * (rij - Rj)) * (inv_far * inv_far - inv_Ri * inv_Ri)
        half_log = 0.5 * math.log(far * inv_Ri)
        return TWOPI * ((inv_Ri - inv_far) + (quad - half_log) / rij)
    # one sphere contains the other
    if Ri > Rj:
        return 0.0
    far = rij + Rj
    near = Rj - rij
    diff2 = -far * near  # rij^2 - Rj^2
    if rij < 0.001 * Rj:
        # removable singularity of (1/2a) log((1+a)/(1-a)) at a = 0
        a = rij / Rj
        log_term_over_r = (1.0 + TWOTHIRDS * a * a) / Rj
        return TWOPI * (2.0 / Ri + Rj / diff2 - log_term_over_r)
    half_log = 0.5 * math.log(far / near)
    return TWOPI * (2.0 / Ri + Rj / diff2 - half_log / rij)


def _ogauss(d2, pi_, pj, ai, aj):
    deltai = 1.0 / (ai + aj)
    kappa = math.exp(-ai * aj * d2 * deltai)
    return pi_ * pj * kappa * (pi_ * deltai) ** 1.5


def i4ov(rij: float, Ri: float, Rj: float, gvol12_factor: float = 0.0) -> float:
    """i4 with Rj inflated by the Gaussian pair-overlap volume.

    gvol12_factor is 0 for AGBNP1, so this reduces to i4 (reference
    AGBNPUtils.cpp:87-97, 121-123).
    """
    if gvol12_factor == 0.0:
        return i4(rij, Ri, Rj)
    ai = KFC / (Ri * Ri)
    aj = KFC / (Rj * Rj)
    gvol = _ogauss(rij * rij, PFC, PFC, ai, aj)
    volj = 4.0 * PI * Rj ** 3 / 3.0
    newRj = ((volj + gvol12_factor * gvol) / volj) ** (1.0 / 3.0) * Rj
    return i4(rij, Ri, newRj)


def switching_function(x: float, xa: float, xb: float) -> float:
    """Quintic 1 -> 0 switch on [xa, xb] (reference AGBNPUtils.cpp:13-25)."""
    if x > xb:
        return 0.0
    if x < xa:
        return 1.0
    d = 1.0 / (xb - xa)
    u = (x - xa) * d
    u2 = u * u
    u3 = u * u2
    return 1.0 - u3 * (10.0 - 15.0 * u + 6.0 * u2)


def natural_spline_y2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives of the natural cubic spline through (x, y).

    Natural boundary conditions y2[0] = y2[-1] = 0; standard tridiagonal
    solve.  Equivalent to OpenMM's SplineFitter::createNaturalSpline used by
    the reference lookup tables (AGBNPUtils.h:99-120).
    """
    n = len(x)
    y2 = np.zeros(n)
    u = np.zeros(n)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        u[i] = ((y[i + 1] - y[i]) / (x[i + 1] - x[i])
                - (y[i] - y[i - 1]) / (x[i] - x[i - 1]))
        u[i] = (6.0 * u[i] / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def spline_eval(x: np.ndarray, y: np.ndarray, y2: np.ndarray, t: float) -> float:
    k = int(np.searchsorted(x, t) - 1)
    k = max(0, min(k, len(x) - 2))
    h = x[k + 1] - x[k]
    a = (x[k + 1] - t) / h
    b = 1.0 - a
    return (a * y[k] + b * y[k + 1]
            + ((a ** 3 - a) * y2[k] + (b ** 3 - b) * y2[k + 1]) * h * h / 6.0)


def spline_evalderiv(x: np.ndarray, y: np.ndarray, y2: np.ndarray, t: float) -> float:
    k = int(np.searchsorted(x, t) - 1)
    k = max(0, min(k, len(x) - 2))
    h = x[k + 1] - x[k]
    a = (x[k + 1] - t) / h
    b = 1.0 - a
    return ((y[k + 1] - y[k]) / h
            + ((3.0 * b * b - 1.0) * y2[k + 1] - (3.0 * a * a - 1.0) * y2[k]) * h / 6.0)


class I4LookupTables:
    """Dense per-(screened type, screener type) spline tables for Q4ij.

    Mirrors AGBNPI42DLookupTable (reference AGBNPUtils.cpp:134-214):
      * unique radii quantized at 1e-4 nm define the radius types,
      * hydrogens never screen (screener type -1),
      * each table has AGBNP_I4LOOKUP_NA nodes on [0, AGBNP_I4LOOKUP_MAXA]
        with the value switched to zero between the midpoint and rmax.

    Exposes dense arrays for the pair sweeps:
      xnodes [NA], yval [Ti, Tj, NA], y2val [Ti, Tj, NA].
    """

    def __init__(self, radii_vdw, ishydrogen,
                 size: int = AGBNP_I4LOOKUP_NA,
                 rmin: float = 0.0, rmax: float = AGBNP_I4LOOKUP_MAXA,
                 version: int = 1):
        radii_vdw = np.asarray(radii_vdw, dtype=np.float64)
        ishydrogen = np.asarray(ishydrogen, dtype=np.int64)
        n = len(radii_vdw)

        def quantize(r):
            return int(r * AGBNP_RADIUS_PRECISION)

        uniq_i = sorted({quantize(r) for r in radii_vdw})
        uniq_j = sorted({quantize(r) for r, h in zip(radii_vdw, ishydrogen) if not h})
        self.ntypes_screened = len(uniq_i)
        self.ntypes_screener = len(uniq_j)
        qi_index = {q: t for t, q in enumerate(uniq_i)}
        qj_index = {q: t for t, q in enumerate(uniq_j)}

        # representative radius per type: first atom radius mapping to the key
        rep_i = {}
        rep_j = {}
        for r, h in zip(radii_vdw, ishydrogen):
            rep_i.setdefault(quantize(r), float(r))
            if not h:
                rep_j.setdefault(quantize(r), float(r))

        self.type_screened = np.array([qi_index[quantize(r)] for r in radii_vdw],
                                      dtype=np.int64)
        self.type_screener = np.array(
            [-1 if h else qj_index[quantize(r)] for r, h in zip(radii_vdw, ishydrogen)],
            dtype=np.int64)

        dr = (rmax - rmin) / (size - 1)
        xa = 0.5 * (rmax + rmin)
        xb = rmax
        self.xnodes = rmin + dr * np.arange(size)
        self.yval = np.zeros((self.ntypes_screened, self.ntypes_screener, size))
        self.y2val = np.zeros_like(self.yval)
        gvol12_factor = 0.0  # AGBNP1 (reference AGBNPUtils.cpp:121-123)
        for qi, ti in qi_index.items():
            Ri = rep_i[qi]
            for qj, tj in qj_index.items():
                Rj = rep_j[qj]
                y = np.array([switching_function(x, xa, xb) * i4ov(x, Ri, Rj, gvol12_factor)
                              for x in self.xnodes])
                self.yval[ti, tj] = y
                self.y2val[ti, tj] = natural_spline_y2(self.xnodes, y)

    def eval(self, d: float, type_i: int, type_j: int) -> float:
        if type_i < 0 or type_j < 0:
            raise ValueError("invalid radius type index")
        return spline_eval(self.xnodes, self.yval[type_i, type_j],
                           self.y2val[type_i, type_j], d)

    def evalderiv(self, d: float, type_i: int, type_j: int) -> float:
        if type_i < 0 or type_j < 0:
            raise ValueError("invalid radius type index")
        return spline_evalderiv(self.xnodes, self.yval[type_i, type_j],
                                self.y2val[type_i, type_j], d)
