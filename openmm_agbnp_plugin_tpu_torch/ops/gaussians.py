"""Vectorized Gaussian-overlap primitives (reference gaussvol.cpp:18-93).

Elementwise over arbitrary batch shapes; the tree build and rescans
(ops/tree.py) call them on whole levels at once.
"""

from __future__ import annotations

import torch

from ..models.constants import KFC, MIN_GVOL, PI, VOLMINA, VOLMINB


def pol_switchfunc(gvol):
    """Quintic switching function on overlap volume; returns (s, sp).

    s ramps 0->1 over [VOLMINA, VOLMINB]; sp = ds/dV.  Branch-free with
    clamping and C1 like the reference (gaussvol.cpp:18-41).
    """
    swu = torch.clamp((gvol - VOLMINA) / (VOLMINB - VOLMINA), 0.0, 1.0)
    swd = 1.0 / (VOLMINB - VOLMINA)
    swu2 = swu * swu
    swu3 = swu * swu2
    s = swu3 * (10.0 - 15.0 * swu + 6.0 * swu2)
    in_window = (gvol > VOLMINA) & (gvol < VOLMINB)
    sp = torch.where(in_window, swd * 30.0 * swu2 * (1.0 - 2.0 * swu + swu2),
                     torch.zeros_like(gvol))
    return s, sp


def atomic_gaussian_exponent(radius):
    """a = KFC / r^2 (gaussvol.cpp:131)."""
    return KFC / (radius * radius)


def ogauss(v1, a1, c1, v2, a2, c2):
    """Product of two Gaussians in (V, a, c) form, vectorized.

    Shapes: v/a [...], c [..., 3].  Returns a dict with
      sgvol:  switched volume s*V12
      gv:     unswitched product volume V12
      ga:     product exponent a1+a2
      gc:     product center
      dVdr:   (1/r) dV12/dr (unswitched)
      dVdV:   dV12/dV1 (unswitched)
      sfp:    d(sV)/dV
    following reference gaussvol.cpp:60-93.
    """
    dist = c2 - c1
    d2 = torch.sum(dist * dist, dim=-1)
    a12 = a1 + a2
    deltai = 1.0 / a12
    df = a1 * a2 * deltai

    ef = torch.exp(-df * d2)
    gvol = (v1 * v2 / (PI / df) ** 1.5) * ef
    dgvol = -2.0 * df * gvol
    pos = v1 > 0
    dgvolv = torch.where(pos, gvol / torch.where(pos, v1, torch.ones_like(v1)),
                         torch.zeros_like(gvol))

    gc = (c1 * a1[..., None] + c2 * a2[..., None]) * deltai[..., None]

    s, sp = pol_switchfunc(gvol)
    sfp = sp * gvol + s
    return dict(sgvol=s * gvol, gv=gvol, ga=a12, gc=gc,
                dVdr=dgvol, dVdV=dgvolv, sfp=sfp)


def survives(sgvol):
    """Tree pruning criterion (gaussvol.cpp:233): switched volume > FLT_MIN."""
    return sgvol > MIN_GVOL
