"""The least work of the Born, GB and descreening pair sweeps, counted from
positions, and its least time on the card.

The count follows what the inputs need, not how today's kernels walk
them: the live pairs are found here from the positions (not from the
program's lists), each pair's distance is computed once, each atom's
inputs are read once and its outputs written once.  FP32 operations, each
+, -, *, /, sqrt and exp one:

* distance of a pair: 3 differences, 3 squares, 2 sums, 1 sqrt = 9;
* an ordered (screened i, heavy screener j) pair within the descreening
  horizon: the spline's Q and dQ/dd 35 (segment 2, weights 4, Q 14, dQ
  15), the Born sum s_j Q 2, the descreening term 18 (W_j and U_j 4,
  the radial factor 4, the pair force 6 and its reaction 3, the sum 1);
* an unordered pair within the GB cutoff: the GB pair 37 (B_i B_j 1, the
  exponent 3, exp 1, the root 4, the charge product 2, the energy 2, the
  cube 2, the radial factor 5, the pair force 6 and its reaction 3, the
  Y term 6, its two sums 2).

The GB kernel also carries the MM LJ + Coulomb sum, whose work is not
counted: a share computed from this count is understated, never
overstated.  Bytes: per atom, position, radius type, charge, s_j, the
Born radius and the two chain factors read (36 bytes), and the inverse
Born radius, force, W, U and Y written (32 bytes), plus the spline tables.
"""

from __future__ import annotations

import json
import os

import torch

DISTANCE = 9
BORN_PAIR = 35 + 2 + 18
GB_PAIR = 37
ATOM_BYTES = 36 + 32
HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def live_pairs(pos, heavy, horizon, cutoff, block: int = 1024):
    """(distances, ordered Born pairs, GB pairs) of one system at pos
    [N, 3]: unordered pairs whose distance a sweep needs, ordered pairs
    (i, heavy j != i) within the horizon, unordered pairs within the
    cutoff (every pair where cutoff is None)."""
    n = pos.shape[0]
    ids = torch.arange(n, device=pos.device)
    hv = heavy.to(pos.device)
    nd = nb = ng = 0
    for s in range(0, n, block):
        rows = ids[s:s + block]
        d2 = torch.sum((pos[None, :, :] - pos[rows, None, :]) ** 2, dim=-1)
        upper = ids[None, :] > rows[:, None]
        near = d2 < horizon * horizon
        born = near & hv[None, :] & (ids[None, :] != rows[:, None])
        gb = upper if cutoff is None else upper & (d2 < cutoff * cutoff)
        need = gb | (upper & near & (hv[None, :] | hv[rows, None]))
        nd += int(need.sum())
        nb += int(born.sum())
        ng += int(gb.sum())
    return nd, nb, ng


def pair_work(positions, heavy, horizon, cutoff, table_bytes: int):
    """(FP32 operations, bytes) of one evaluation of each system in
    positions [B, N, 3] (a batch: the sum over its systems)."""
    flops = nbytes = 0
    for pos in positions:
        nd, nb, ng = live_pairs(pos.double(), heavy, horizon, cutoff)
        flops += DISTANCE * nd + BORN_PAIR * nb + GB_PAIR * ng
        nbytes += ATOM_BYTES * pos.shape[0] + table_bytes
    return flops, nbytes


def least_seconds(flops: int, nbytes: int) -> float:
    """The least time of that work on the card: the larger of operations
    over the FP32 peak and bytes over the memory bandwidth."""
    p = peaks()
    return max(flops / p["fp32_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
