"""Padded half neighbor lists for the tree build and MD loop.

The reference relies on OpenMM's neighbor-list tiles for its 2-body overlap
candidates (reference GVolOverlapTree.cl:127-313).  Here the analogue is a
fixed-width half list [N, kmax] rebuilt on the device: candidate (i, j>i)
pairs within rcut, heavy atoms only (hydrogen Gaussians carry zero volume
and can never form a surviving overlap, gaussvol.cpp:132), padded with a
validity mask and an overflow indicator.

The tree's 2-body survival criterion implies a hard geometric cutoff:
s(V12) V12 > MIN_GVOL requires V12 > VOLMINA, i.e.
d^2 < ln(v1 v2 (df/pi)^1.5 / VOLMINA) / df; `tree_pair_cutoff` evaluates it
for the worst-case (largest) radii so the list provably misses no overlap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.constants import KFC, PI, VOLMINA, sphere_volume


def tree_pair_cutoff(radii_large) -> float:
    """Max distance at which a 2-body overlap (largest radii) can survive."""
    rmax = float(np.max(np.asarray(radii_large)))
    v = sphere_volume(rmax)
    a = KFC / (rmax * rmax)
    df = 0.5 * a
    pref = v * v * (df / PI) ** 1.5
    if pref <= VOLMINA:
        return 0.0
    return math.sqrt(math.log(pref / VOLMINA) / df)


def host_max_neighbors(pos, heavy, rcut, chunk: int = 2048):
    """Max half-list neighbor count (numpy), row-chunked so host memory
    stays O(N*chunk) — the sizing pass for kmax."""
    n = pos.shape[0]
    jj = np.arange(n)
    best = 0
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = np.sum((pos[s:e, None, :] - pos[None, :, :]) ** 2, axis=-1)
        ok = ((jj[None, :] > jj[s:e, None]) & (d2 < rcut * rcut)
              & heavy[s:e, None] & heavy[None, :])
        best = max(best, int(ok.sum(axis=1).max()))
    return best


def half_neighbor_pairs(pos, heavy_mask, rcut: float, kmax: int):
    """Fixed-width half neighbor list as flat i-major candidate pairs.

    Returns (pairs_i [N*kmax], pairs_j, pairs_valid, max_neighbors), all on
    pos.device.  Invalid slots have pairs_j == pairs_i (masked out
    downstream).  max_neighbors > kmax signals overflow.
    """
    n = pos.shape[0]
    dist = pos[None, :, :] - pos[:, None, :]
    d2 = torch.sum(dist * dist, dim=-1)
    jj = torch.arange(n, device=pos.device)
    pair_ok = ((jj[None, :] > jj[:, None])
               & (d2 < rcut * rcut)
               & heavy_mask[:, None] & heavy_mask[None, :])
    # ascending-j order with invalid slots pushed to the end: the key IS the
    # neighbor index, so a value sort yields pj directly
    key = torch.where(pair_ok, jj[None, :], n)
    pj = torch.sort(key, dim=1).values[:, :kmax]
    valid = pj < n
    pi = jj[:, None].expand(n, pj.shape[1])
    pj = torch.where(valid, pj, pi)
    max_neighbors = torch.max(torch.sum(pair_ok, dim=1))
    return pi.reshape(-1), pj.reshape(-1), valid.reshape(-1), max_neighbors
