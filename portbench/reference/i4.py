"""The I4 descreening integral and its spline tables, in float64 NumPy.

Q4(d; Ri, Rj) is the integral of 1/r^4 over the part of sphere j (radius
Rj at distance d) outside sphere i (Grycuk, J. Chem. Phys. 119, 4817
(2003)).  The AGBNP plugin tabulates it per pair of radius types (radii
quantised at 1e-4 nm; hydrogens never screen) at 16 nodes on [0, 2] nm,
switched to zero between 1 and 2 nm, and evaluates natural cubic splines
through the nodes (AGBNPUtils.cpp).
"""

from __future__ import annotations

import math

import numpy as np

NODES = 16
XMAX = 2.0


def i4(d, ri, rj):
    """The I4 integral at distance d for screened radius ri, screener rj."""
    two_pi = 2.0 * math.pi
    if d > ri + rj:
        far, near = d + rj, d - rj
        return two_pi * (rj / (far * near) - 0.5 * math.log(far / near) / d)
    if d * d > (rj - ri) ** 2:
        far = d + rj
        quad = 0.25 * far * (d - rj) * (1.0 / far ** 2 - 1.0 / ri ** 2)
        return two_pi * ((1.0 / ri - 1.0 / far)
                         + (quad - 0.5 * math.log(far / ri)) / d)
    if ri > rj:
        return 0.0
    far, near = d + rj, rj - d
    if d < 0.001 * rj:
        a = d / rj
        log_over_d = (1.0 + 2.0 / 3.0 * a * a) / rj
    else:
        log_over_d = 0.5 * math.log(far / near) / d
    return two_pi * (2.0 / ri - rj / (far * near) - log_over_d)


def _switch(x, xa, xb):
    if x > xb:
        return 0.0
    if x < xa:
        return 1.0
    u = (x - xa) / (xb - xa)
    return 1.0 - u ** 3 * (10.0 - 15.0 * u + 6.0 * u * u)


def _natural_y2(x, y):
    n = len(x)
    y2, u = np.zeros(n), np.zeros(n)
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


class I4Tables:
    """Spline nodes y and second derivatives y2 [Ti, Tj, NODES] per pair of
    (screened, screener) radius types, and each atom's types."""

    def __init__(self, radius, hydrogen):
        key = [int(r * 10000) for r in radius]
        # a type's radius is that of its first atom (of its first heavy
        # atom for the screeners)
        rep_i, rep_j = {}, {}
        for k, r, h in zip(key, radius, hydrogen):
            rep_i.setdefault(k, float(r))
            if not h:
                rep_j.setdefault(k, float(r))
        types_i, types_j = sorted(rep_i), sorted(rep_j)
        ti = {k: t for t, k in enumerate(types_i)}
        tj = {k: t for t, k in enumerate(types_j)}
        self.type_screened = np.array([ti[k] for k in key])
        self.type_screener = np.array([-1 if h else tj[k]
                                       for k, h in zip(key, hydrogen)])
        self.h = XMAX / (NODES - 1)
        x = self.h * np.arange(NODES)
        self.y = np.zeros((len(types_i), len(types_j), NODES))
        self.y2 = np.zeros_like(self.y)
        for a, ka in enumerate(types_i):
            for b, kb in enumerate(types_j):
                y = np.array([_switch(v, 0.5 * XMAX, XMAX)
                              * i4(v, rep_i[ka], rep_j[kb]) for v in x])
                self.y[a, b] = y
                self.y2[a, b] = _natural_y2(x, y)
