"""Flattened fixed-shape Gaussian overlap tree (PyTorch).

Counterpart of the JAX package's ops/tree.py and of the reference's
recursive overlap tree (gaussvol/gaussvol.cpp:103-519).  Each overlap level
k (2..MAX_ORDER) is a dense padded array of nodes with a validity mask:

  level k arrays [cap_k]: atom (last atom of the k-tuple), parent (index into
  the level k-1 arrays), product Gaussian (gv, ga, gc), switched volume,
  switch chain factor sfp, dV/dV_parent (dvv1), position-gradient piece dv1,
  gamma sum gamma1i, valid.

Construction is level-synchronous: level-(k+1) candidates are sibling pairs
(nodes sharing a parent) enumerated with a static per-level sibling-offset
window, pruned by the switching threshold and compacted into the next
level's capacity grouped by parent and volume-sorted within each group (the
reference's descending-volume sibling order, gaussvol.cpp:169-171).

The bottom-up volume/energy/gradient reduction (gaussvol.cpp:400-519)
becomes per-level segment sums.  Every segment sum here is a sorted
`torch.segment_reduce`, which adds each segment's rows one after another in
row order: the result is bitwise the same from run to run on the GPU too
(no float atomics), which the checkpoint-resume contract of the MD loop
rests on.

Capacity overflow is detected and reported (the PanicButton analogue,
OpenCLAGBNPKernels.cpp:3598-3634): the host checks the returned diagnostics
and rebuilds with larger capacities.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.constants import MAX_ORDER, PI, VOLMINA
from .gaussians import atomic_gaussian_exponent, pol_switchfunc, survives

# Levels 2..MAX_ORDER are stored; index l in tuples below is level l+2.
NUM_TREE_LEVELS = MAX_ORDER - 1  # 7


@dataclasses.dataclass(frozen=True)
class TreeCaps:
    """Static per-level capacities and sibling-offset windows.

    caps[l]: max nodes at level l+2.
    offs[l]: max sibling offset used when generating level l+3 from level l+2
             (must be >= max surviving children-per-parent minus one).
    """

    caps: tuple
    offs: tuple

    @staticmethod
    def for_natoms(natoms: int, boost: float = 1.0) -> "TreeCaps":
        def r(x, align=128):
            v = int(np.ceil(x * boost))
            return max(align, (v + align - 1) // align * align)

        caps = (r(12 * natoms), r(28 * natoms), r(26 * natoms),
                r(14 * natoms), r(5 * natoms), r(1 * natoms), r(natoms // 2))
        offs = (48, 32, 24, 16, 8, 4)
        return TreeCaps(caps=caps, offs=offs)

    def grow(self, level_overflows, sib_overflows=None) -> "TreeCaps":
        """Double capacities/windows of overflowed levels (PanicButton
        resize, OpenCLAGBNPKernels.cpp:340-343)."""
        caps = tuple(c * 2 if ov else c
                     for c, ov in zip(self.caps, level_overflows))
        offs = self.offs
        if sib_overflows is not None:
            offs = tuple(o * 2 if ov else o
                         for o, ov in zip(self.offs, sib_overflows))
        return TreeCaps(caps=caps, offs=offs)


def segment_sum(x, ids, num_segments: int, ids_sorted: bool = False):
    """Deterministic segment sum of rows x [R, C] into [num_segments, C].

    Rows are grouped by a stable sort of ids (skipped when the ids are
    already nondecreasing) and each segment is summed in row order."""
    if not ids_sorted:
        order = torch.argsort(ids, stable=True)
        ids = ids[order]
        x = x[order]
    lengths = torch.zeros(num_segments, dtype=torch.int64, device=x.device)
    lengths.index_add_(0, ids.long(), torch.ones_like(ids, dtype=torch.int64))
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def make_level1(pos, radius, volume, gamma, ishydrogen):
    """Level-1 (atomic) node arrays.

    Mirrors init_overlap_tree's 1-body seeding (gaussvol.cpp:129-148):
    a = KFC/r^2, volume zeroed for hydrogens.
    """
    vol = torch.where(ishydrogen > 0, 0.0, volume)
    ga = atomic_gaussian_exponent(radius)
    at = torch.cat([vol[:, None], ga[:, None], pos, gamma[:, None]],
                   dim=1)  # packed [N, 6]: gv, ga, gc, gamma
    return dict(gv=vol, ga=ga, gc=pos, gamma1i=gamma, _at=at)


# Packed per-level float layout [cap, 13]:
#   0 gv, 1 ga, 2:5 gc, 5 volume(switched), 6 sfp, 7 dvv1, 8:11 dv1,
#   11 gamma1i, 12 ai (atomic exponent of the last atom)
_D = 13


def _level_views(dat, ints, valid):
    return dict(_dat=dat, _ints=ints, atom=ints[:, 0], parent=ints[:, 1],
                valid=valid,
                gv=dat[:, 0], ga=dat[:, 1], gc=dat[:, 2:5],
                volume=dat[:, 5], sfp=dat[:, 6], dvv1=dat[:, 7],
                dv1=dat[:, 8:11], gamma1i=dat[:, 11], ai=dat[:, 12])


def _cand_dat(s_gv, s_ga, s_gc, s_gamma, a):
    """Packed 2-Gaussian product: s-side scalars x atomic packed rows
    (a[..., 6]: gv, ga, gc, gamma).  Returns (dat[..., _D], sgvol).

    Degenerate (zero-padded) rows would give df = 0*inf = NaN; every
    division is guarded so junk rows stay finite."""
    a_gv = a[..., 0]
    a_ga = a[..., 1]
    a_gc = a[..., 2:5]
    dist = a_gc - s_gc
    d2 = torch.sum(dist * dist, dim=-1)
    a12 = s_ga + a_ga
    ok = (s_ga > 0.0) & (a_ga > 0.0)
    deltai = 1.0 / torch.where(a12 > 0.0, a12, 1.0)
    df = s_ga * a_ga * deltai
    ef = torch.exp(-df * d2)
    df_safe = torch.where(ok, df, 1.0)
    gvol = torch.where(ok, (s_gv * a_gv * (df_safe / PI) ** 1.5) * ef, 0.0)
    dgvol = -2.0 * df * gvol
    sv_pos = s_gv > 0
    dgvolv = torch.where(sv_pos, gvol / torch.where(sv_pos, s_gv, 1.0), 0.0)
    gc12 = (s_gc * s_ga[..., None] + a_gc * a_ga[..., None]) * deltai[..., None]
    s, sp = pol_switchfunc(gvol)
    sgvol = s * gvol
    sfp = sp * gvol + s
    dv1 = dist * (-dgvol)[..., None]
    dat = torch.cat([
        gvol[..., None], a12[..., None], gc12, sgvol[..., None],
        sfp[..., None], dgvolv[..., None], dv1,
        (s_gamma + a[..., 5])[..., None],
        torch.broadcast_to(a_ga, gvol.shape)[..., None],   # ai passthrough
    ], dim=-1)
    return dat, sgvol


def _nonzero_padded(mask, size: int):
    """Indices of the True entries of a 1-D mask, in order, padded or cut to
    `size` without a host sync (the tail past the True count is junk that
    callers mask)."""
    idx = torch.argsort((~mask).to(torch.int32), stable=True)[:size]
    if idx.shape[0] < size:
        idx = torch.cat([idx, idx.new_zeros(size - idx.shape[0])])
    return idx


def _compact(mask, cand_dat, cand_ints, cap, parent_cap):
    """Pack masked candidates into a fixed-capacity level, grouped by parent
    and volume-sorted within each group (add_children's descending-volume
    sibling order, gaussvol.cpp:169-171)."""
    count = torch.sum(mask)
    idx = _nonzero_padded(mask, cap)
    valid = torch.arange(cap, device=mask.device) < count

    parent_key = torch.where(valid, cand_ints[:, 1][idx], parent_cap)
    vol_key = torch.where(valid, cand_dat[:, 5][idx], 0.0)
    # lexsort (parent asc, volume desc) as two stable sorts; invalid slots
    # carry the max parent sentinel and stay at the tail
    o1 = torch.argsort(-vol_key, stable=True)
    perm = o1[torch.argsort(parent_key[o1], stable=True)]
    idx = idx[perm]

    dat = torch.where(valid[:, None], cand_dat[idx], 0.0)
    ints = torch.where(valid[:, None], cand_ints[idx], 0)
    lvl = _level_views(dat, ints, valid)
    # monotone segment-id vector of the packed (parent-sorted) layout
    lvl["bnd"] = dict(pmono=torch.cummax(
        torch.where(valid, lvl["parent"], 0), dim=0).values)
    return lvl, count


def _pair_candidates(level1, pairs_i, pairs_j, pairs_valid=None):
    """2-body overlaps for the given (i, j) candidate pairs (i-major order)."""
    at = level1["_at"]
    si = at[pairs_i]
    dat, sgvol = _cand_dat(si[:, 0], si[:, 1], si[:, 2:5], si[:, 5],
                           at[pairs_j])
    mask = survives(sgvol)
    if pairs_valid is not None:
        mask = mask & pairs_valid
    ints = torch.stack([pairs_j, pairs_i], dim=1).long()
    return dat, ints, mask


def _compact_rows(key, mask, cap):
    """Row-structured compaction: pack survivors of a [rows, width] candidate
    grid into a fixed-cap level, row-grouped with key-descending order within
    each row (rows are parents, so this reproduces _compact's
    (parent asc, volume desc) order with one per-row sort and O(rows)
    placement).

    Returns (row_of_slot, off_of_slot, valid, count, cnt, bnd) where off is
    the within-row candidate offset; bnd carries pmono, the monotone
    per-parent segment-id vector of the packed layout.
    """
    rows, width = key.shape
    dev = key.device
    skey = torch.where(mask, -key, float("inf"))
    off_sorted = torch.sort(skey, dim=1, stable=True).indices
    cnt = torch.sum(mask, dim=1)
    ends = torch.cumsum(cnt, dim=0)
    starts = ends - cnt
    count = ends[-1]
    # row id per output slot: +1 at every row start (duplicates from empty
    # rows make the running count skip them), then an inclusive scan; row
    # starts past the capacity are dropped into a spare slot
    marks = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, torch.clamp(starts, max=cap), torch.ones_like(starts))
    slot = torch.arange(cap, device=dev)
    row = torch.clamp(torch.cumsum(marks[:cap], dim=0) - 1, 0, rows - 1)
    pos = slot - starts[row]
    off = off_sorted.reshape(-1)[row * width + torch.clamp(pos, 0, width - 1)]
    valid = slot < count
    return row, off, valid, count, cnt, dict(pmono=row)


def _build_sibling_level(prev_lvl, prev_a6, level1, offs, cap):
    """Next-level build: the partner of each node is taken from a window of
    the next `offs` rows of the same (parent-grouped) level; partners
    sharing the parent form the sibling-pair candidates.  Returns
    (lvl, a6, count, max_sib) with a6 the atomic rows of each node's atom."""
    cap_prev = prev_lvl["_dat"].shape[0]
    dev = prev_a6.device
    src_i = torch.cat([prev_lvl["_ints"],
                       prev_lvl["valid"][:, None].long()], dim=1)
    srcp_i = torch.cat([src_i, src_i.new_full((offs, 3), -1)])
    srcp_a = torch.cat([prev_a6, prev_a6.new_zeros((offs, 6))])
    win = (torch.arange(cap_prev, device=dev)[:, None]
           + torch.arange(1, offs + 1, device=dev)[None, :])
    win_i = srcp_i[win]   # [cap_prev, offs, 3]
    win_a = srcp_a[win]   # [cap_prev, offs, 6]
    pair_ok = ((win_i[:, :, 2] > 0)
               & prev_lvl["valid"][:, None]
               & (win_i[:, :, 1] == prev_lvl["parent"][:, None]))

    dat_s = prev_lvl["_dat"]
    dat, sgvol = _cand_dat(dat_s[:, 0:1], dat_s[:, 1:2],
                           dat_s[:, None, 2:5], dat_s[:, 11:12], win_a)
    mask = pair_ok & survives(sgvol)

    row, off, valid, count, cnt, bnd = _compact_rows(dat[:, :, 5], mask, cap)
    idx = row * offs + off
    out_dat = torch.where(valid[:, None],
                          dat.reshape(cap_prev * offs, _D)[idx], 0.0)
    atom2 = torch.where(valid, win_i[:, :, 0].reshape(-1)[idx], 0)
    ints = torch.stack([atom2, torch.where(valid, row, 0)], dim=1)
    a6 = level1["_at"][atom2]
    lvl = _level_views(out_dat, ints, valid)
    lvl["bnd"] = bnd
    return lvl, a6, count, torch.max(cnt)


def _build_pair_level(level1, pj2d, pv2d, cap):
    """Level-2 build from a fixed-width i-major neighbor grid [N, kmax]
    (half_neighbor_pairs layout): the i side is a broadcast and compaction
    is row-structured.  Returns (lvl, a6, count, max_sib)."""
    at = level1["_at"]
    n, kmax = pj2d.shape
    a = at[pj2d]  # [n, kmax, 6]
    dat, sgvol = _cand_dat(at[:, 0:1], at[:, 1:2], at[:, None, 2:5],
                           at[:, 5:6], a)
    mask = survives(sgvol)
    if pv2d is not None:
        mask = mask & pv2d

    row, off, valid, count, cnt, bnd = _compact_rows(dat[:, :, 5], mask, cap)
    idx = row * kmax + off
    out_dat = torch.where(valid[:, None], dat.reshape(n * kmax, _D)[idx], 0.0)
    atom2 = torch.where(valid, pj2d.reshape(-1)[idx].long(), 0)
    ints = torch.stack([atom2, torch.where(valid, row, 0)], dim=1)
    a6 = at[atom2]
    lvl = _level_views(out_dat, ints, valid)
    lvl["bnd"] = bnd
    return lvl, a6, count, torch.max(cnt)


def _max_siblings(level, parent_cap):
    """Largest number of surviving children under one parent."""
    cnt = torch.zeros(parent_cap, dtype=torch.int64,
                      device=level["valid"].device)
    cnt.index_add_(0, level["parent"], level["valid"].long())
    return torch.max(cnt)


def build_tree(level1, pairs_i, pairs_j, caps: TreeCaps, pairs_valid=None,
               pair_rows: bool = False):
    """Builds all overlap levels 2..MAX_ORDER.

    pairs_i/pairs_j: candidate 2-body pairs (i < j), i-major order — from an
    all-pairs enumeration or a padded neighbor list (pairs_valid masks the
    list's padding slots; with pair_rows the list is the fixed-width
    [N, kmax] grid of half_neighbor_pairs and level 2 takes the row path).
    Returns (levels, diag) where diag carries per-level counts and overflow
    indicators as device tensors.
    """
    natoms = level1["gv"].shape[0]
    dev = level1["gv"].device
    levels = []
    counts = []
    sib_max = []

    if pair_rows:
        pj2d = pairs_j.reshape(natoms, -1)
        pv2d = None if pairs_valid is None else pairs_valid.reshape(natoms, -1)
        lvl, a6, count, msib = _build_pair_level(level1, pj2d, pv2d,
                                                 caps.caps[0])
    else:
        dat, cints, mask = _pair_candidates(level1, pairs_i, pairs_j,
                                            pairs_valid)
        lvl, count = _compact(mask, dat, cints, caps.caps[0], natoms)
        a6 = level1["_at"][lvl["atom"]]
        msib = _max_siblings(lvl, natoms)
    levels.append(lvl)
    counts.append(count)
    sib_max.append(msib)

    for l in range(1, NUM_TREE_LEVELS):
        lvl, a6, count, msib = _build_sibling_level(
            levels[-1], a6, level1, caps.offs[l - 1], caps.caps[l])
        levels.append(lvl)
        counts.append(count)
        sib_max.append(msib)

    diag = dict(
        counts=torch.stack(counts).long(),
        caps=torch.tensor(caps.caps, device=dev),
        max_siblings=torch.stack(sib_max).long(),
        offs=torch.tensor(caps.offs + (0,), device=dev),
    )
    return tuple(levels), diag


def merge_counts(a, b):
    """Elementwise max of two overflow-count vectors, zero-padding the
    shorter."""
    a = a.long()
    b = b.long()
    if a.shape[0] < b.shape[0]:
        a = torch.cat([a, a.new_zeros(b.shape[0] - a.shape[0])])
    elif b.shape[0] < a.shape[0]:
        b = torch.cat([b, b.new_zeros(a.shape[0] - b.shape[0])])
    return torch.maximum(a, b)


def check_overflow(diag) -> dict:
    """Host-side PanicButton check. Returns numpy bools per level."""
    counts = np.asarray(diag["counts"].cpu())
    caps = np.asarray(diag["caps"].cpu())
    sibs = np.asarray(diag["max_siblings"].cpu())
    offs = np.asarray(diag["offs"].cpu())
    cap_overflow = counts > caps
    sib_overflow = np.zeros_like(cap_overflow)
    sib_overflow[:-1] = (sibs[:-1] - 1) > offs[:-1]
    return dict(cap_overflow=cap_overflow, sib_overflow=sib_overflow,
                any=bool(cap_overflow.any() or sib_overflow.any()))


def _parent_gather(x, lvl):
    """Parent rows x[parent] of a level.  With build boundaries the monotone
    segment ids (pmono) stand in for the raw parent indices: identical for
    every valid slot; invalid slots read junk that every consumer masks."""
    bnd = lvl.get("bnd")
    if bnd is not None:
        return x[bnd["pmono"]]
    return x[lvl["parent"]]


def _upward_segment_sum(x, lvl, num_parents):
    """The per-level child -> parent reduction of x [cap, C]."""
    if "bnd" in lvl:
        return segment_sum(x, lvl["bnd"]["pmono"], num_parents,
                           ids_sorted=True)
    return segment_sum(x, lvl["parent"], num_parents)


def tree_topology(levels):
    """Extract the shape-static topology (indices + validity) of a built
    tree; rescan_volumes reconstructs full levels from it, so the MD loop
    carries just these int arrays between rebuilds."""
    out = []
    for l in levels:
        d = dict(_ints=l["_ints"], valid=l["valid"], atom=l["atom"],
                 parent=l["parent"])
        if "bnd" in l:
            d["bnd"] = l["bnd"]
        out.append(d)
    return tuple(out)


def compact_topology(levels, caps, relax: float = 0.5):
    """Compact a (rescanned) tree to the ancestor closure of its live rows
    (counterpart of the JAX package's ops/tree.py::compact_topology).

    The vdW-channel WU gamma-rescan force pass (ReferenceAGBNPKernels.cpp:
    713-747) runs on the vdW parameterization of the build topology, where
    only a small share of rows has nonzero switched volume.  A row with zero
    switched volume and no live descendant contributes exactly 0.0 to every
    reduction output, so dropping it is exact; keeping rows with raw volume
    > VOLMINA*relax adds a birth margin for drift within an MD window.

    `levels` carry the vdW volumes (a rescan_volumes result); caps gives the
    static per-level compact capacities.  Returns (topology, counts): a
    tree_topology()-shaped tuple with parents remapped to compact slots and
    monotone pmono boundaries (a stable compaction of a parent-sorted level
    stays parent-sorted, so the sorted segment sums apply), and counts [7],
    the pre-truncation kept-row counts (count > cap: live rows were dropped
    and the window must be regrown).  No host sync.
    """
    keep = [l["valid"] & (l["gv"] > VOLMINA * relax) for l in levels]
    # ancestor closure, bottom-up: a kept row's parent chain stays, so
    # parent gathers and the downward chains remain intact (integer amax:
    # order-independent, so deterministic)
    for li in range(len(levels) - 1, 0, -1):
        k = keep[li].to(torch.int32)
        up = torch.zeros(levels[li - 1]["valid"].shape[0], dtype=torch.int32,
                         device=k.device).scatter_reduce(
            0, torch.where(keep[li], levels[li]["parent"], 0), k, "amax")
        keep[li - 1] = keep[li - 1] | ((up > 0) & levels[li - 1]["valid"])

    counts = torch.stack([torch.sum(k) for k in keep])
    out = []
    prev_remap = None  # old parent index -> compact slot of previous level
    prev_cap = None
    for li, (lvl, kp) in enumerate(zip(levels, keep)):
        cap = max(int(caps[li]), 8)
        sel = _nonzero_padded(kp, cap)
        valid = torch.arange(cap, device=kp.device) < torch.clamp(
            counts[li], max=cap)
        atom = torch.where(valid, lvl["atom"][sel], 0)
        parent = lvl["parent"][sel]
        if prev_remap is not None:
            # a parent truncated out of the previous level (an overflowed
            # window, refused by the counts) still indexes inside it
            parent = torch.clamp(prev_remap[parent], max=prev_cap - 1)
        parent = torch.where(valid, parent, 0)
        out.append(dict(_ints=torch.stack([atom, parent], dim=1),
                        valid=valid, atom=atom, parent=parent,
                        bnd=dict(pmono=torch.cummax(parent, dim=0).values)))
        prev_remap = torch.cumsum(kp.to(torch.int64), dim=0) - 1
        prev_cap = cap
    return tuple(out), counts


def rescan_volumes(levels, level1):
    """Recompute all node volumes/Gaussians on the fixed topology (the
    analogue of rescan_tree_v, gaussvol.cpp:254-327): new level-1 data, same
    parent/atom indices, no re-pruning.  Accepts full levels or a
    tree_topology() result."""
    new_levels = []
    # level-1 "dat" is the packed atomic table; map its columns to the same
    # (gv, ga, gc, gamma) positions the level matrices use
    prev_dat, cols = level1["_at"], (0, 1, 2, 5)
    for lvl in levels:
        sp = _parent_gather(prev_dat, lvl)
        g0, g1, gc0, gg = cols
        dat, _ = _cand_dat(sp[:, g0], sp[:, g1], sp[:, gc0:gc0 + 3],
                           sp[:, gg], level1["_at"][lvl["atom"]])
        # zero invalid rows like the build's _compact
        dat = dat * lvl["valid"][:, None].to(dat.dtype)
        nl = _level_views(dat, lvl["_ints"], lvl["valid"])
        if "bnd" in lvl:
            nl["bnd"] = lvl["bnd"]
        new_levels.append(nl)
        prev_dat = dat
        cols = (0, 1, 2, 11)
    return tuple(new_levels)


def rescan_gammas(levels, level1):
    """Propagate new per-atom gammas down the fixed topology
    (rescan_tree_g, gaussvol.cpp:330-372)."""
    gam = level1["gamma1i"]
    new_levels = []
    pg = gam
    for lvl in levels:
        g = _parent_gather(pg, lvl) + gam[lvl["atom"]]
        new_levels.append({**lvl, "gamma1i": g})
        pg = g
    return tuple(new_levels)


def reduce_tree(levels, level1, with_selfvol: bool = True):
    """Bottom-up reduction: energy, gradients, self volumes.

    The flattened form of compute_volume_underslot2_r (gaussvol.cpp:400-519):
    for each level from the deepest up, per-node subtree accumulators are
    combined with the children's segment-summed accumulators, deposited onto
    the node's last atom, transformed by the (dv1, dvv1, a1/a1i) recursion
    and passed to the parents.  The gamma-weighted energy family carries the
    full (psi, F, P) chain (5 channels); the self-volume family only its psi
    scalar.  All channels ride one [cap, C] matrix: one upward segment sum
    per level and one atom-deposit segment sum at the end.

    Returns dict(energy, dr[, self_volume]); dr is the energy gradient wrt
    positions (negate for force).
    """
    natoms = level1["gv"].shape[0]
    dtype = level1["gv"].dtype

    acc = None
    dep_rows = []
    dep_atoms = []

    for l in range(NUM_TREE_LEVELS - 1, -1, -1):
        lvl = levels[l]
        level_no = l + 2
        cf = -1.0 if level_no % 2 == 0 else 1.0
        volcoeffp = cf / level_no
        valid = lvl["valid"]
        vmask = valid.to(dtype)

        ai = lvl["ai"]
        a1i = lvl["ga"]
        safe_a1i = torch.where(valid, a1i, 1.0)
        c2 = ai / safe_a1i
        c2p = (a1i - ai) / safe_a1i

        gsfp = volcoeffp * lvl["sfp"] * lvl["gamma1i"]
        zero = torch.zeros_like(gsfp)
        cols = [volcoeffp * lvl["gamma1i"] * lvl["volume"],   # e_psi
                gsfp, zero, zero, zero]                       # e_f, e_p
        if with_selfvol:
            cols.append(volcoeffp * lvl["volume"])            # sv_psi
        tot = torch.stack(cols, dim=1) * vmask[:, None]
        if acc is not None:
            tot = tot + acc

        e_f = tot[:, 1]
        e_p = tot[:, 2:5]

        dr_dep = (-lvl["dv1"]) * e_f[:, None] + e_p * c2[:, None]
        dep_cols = [dr_dep]
        if with_selfvol:
            dep_cols.append(tot[:, 5:6])
        dep_rows.append(torch.cat(dep_cols, dim=1) * vmask[:, None])
        dep_atoms.append(lvl["atom"])

        p_out = lvl["dv1"] * e_f[:, None] + e_p * c2p[:, None]
        up = torch.cat([
            tot[:, 0:1],                       # e_psi passes through
            (lvl["dvv1"] * e_f)[:, None],      # e_f
            p_out,                             # e_p
            tot[:, 5:],                        # sv psi passes through
        ], dim=1) * vmask[:, None]
        num_parents = natoms if l == 0 else levels[l - 1]["valid"].shape[0]
        acc = _upward_segment_sum(up, lvl, num_parents)

    deposits = segment_sum(torch.cat(dep_rows, dim=0),
                           torch.cat(dep_atoms, dim=0), natoms)

    # level 1 (atoms): volcoeff = volcoeffp = 1, sfp = 1, dvv1 = 1, dv1 = 0,
    # c2 = 1, c2p = 0 (gaussvol.cpp:413-435 with level == 1)
    gamma = level1["gamma1i"]
    vol = level1["gv"]
    e_psi = gamma * vol + acc[:, 0]
    dr = deposits[:, 0:3] + acc[:, 2:5]
    result = dict(energy=torch.sum(e_psi), dr=dr)
    if with_selfvol:
        result["self_volume"] = vol + acc[:, 5] + deposits[:, 3]
    return result


def rescan_volumes2(levels, level1_a, level1_b):
    """Fixed-topology volume rescan for TWO parameterizations at once (the
    cavity term's large and vdW radii, ReferenceAGBNPKernels.cpp:293-384):
    one parent gather of the packed [cap, 2*_D] matrix per level.  Invalid
    rows carry finite junk that every consumer masks.

    Returns (levels_a, levels_b).
    """
    out_a, out_b = [], []
    at2 = torch.cat([level1_a["_at"], level1_b["_at"]], dim=1)  # [N, 12]
    prev = at2
    prev_cols = ((0, 1, 2, 5), (6, 7, 8, 11))  # (gv, ga, gc0, gamma) per half
    for lvl in levels:
        sp = _parent_gather(prev, lvl)
        a2 = at2[lvl["atom"]]
        (ga0, ga1, gac, gag), (gb0, gb1, gbc, gbg) = prev_cols
        dat_a, _ = _cand_dat(sp[:, ga0], sp[:, ga1], sp[:, gac:gac + 3],
                             sp[:, gag], a2[:, 0:6])
        dat_b, _ = _cand_dat(sp[:, gb0], sp[:, gb1], sp[:, gbc:gbc + 3],
                             sp[:, gbg], a2[:, 6:12])
        la = _level_views(dat_a, lvl["_ints"], lvl["valid"])
        lb = _level_views(dat_b, lvl["_ints"], lvl["valid"])
        if "bnd" in lvl:
            la["bnd"] = lvl["bnd"]
            lb["bnd"] = lvl["bnd"]
        out_a.append(la)
        out_b.append(lb)
        prev = torch.cat([dat_a, dat_b], dim=1)  # [cap, 2*_D]
        prev_cols = ((0, 1, 2, 11), (_D, _D + 1, _D + 2, _D + 11))
    return tuple(out_a), tuple(out_b)


def reduce_tree2(levels_a, levels_b, level1_a, level1_b):
    """Bottom-up reduction of two same-topology trees in one sweep.

    Packs both trees' accumulator channels into one matrix so each level
    runs a single upward segment sum; deposits are batched into one.
    Returns (result_a, result_b) like reduce_tree(with_selfvol=False) and
    reduce_tree(with_selfvol=True).
    """
    natoms = level1_a["gv"].shape[0]
    dtype = level1_a["gv"].dtype

    acc = None
    dep_rows = []
    dep_atoms = []

    for l in range(NUM_TREE_LEVELS - 1, -1, -1):
        la = levels_a[l]
        lb = levels_b[l]
        level_no = l + 2
        cf = -1.0 if level_no % 2 == 0 else 1.0
        volcoeffp = cf / level_no
        valid = la["valid"]
        vmask = valid.to(dtype)

        cols = []
        for lv in (la, lb):
            gsfp = volcoeffp * lv["sfp"] * lv["gamma1i"]
            zero = torch.zeros_like(gsfp)
            cols += [volcoeffp * lv["gamma1i"] * lv["volume"], gsfp,
                     zero, zero, zero]
        cols.append(volcoeffp * lb["volume"])
        tot = torch.stack(cols, dim=1) * vmask[:, None]
        if acc is not None:
            tot = tot + acc

        dep_cols = []
        ups = []
        for base, lv in ((0, la), (5, lb)):
            e_f = tot[:, base + 1]
            e_p = tot[:, base + 2:base + 5]
            ai = lv["ai"]
            a1i = lv["ga"]
            safe = torch.where(valid, a1i, 1.0)
            dep_cols.append((-lv["dv1"]) * e_f[:, None]
                            + e_p * (ai / safe)[:, None])
            p_out = (lv["dv1"] * e_f[:, None]
                     + e_p * ((a1i - ai) / safe)[:, None])
            ups += [tot[:, base:base + 1], (lv["dvv1"] * e_f)[:, None], p_out]
        dep_cols.append(tot[:, 10:11])
        ups.append(tot[:, 10:11])
        dep_rows.append(torch.cat(dep_cols, dim=1) * vmask[:, None])
        dep_atoms.append(la["atom"])

        up = torch.cat(ups, dim=1) * vmask[:, None]
        num_parents = natoms if l == 0 else levels_a[l - 1]["valid"].shape[0]
        acc = _upward_segment_sum(up, la, num_parents)

    deposits = segment_sum(torch.cat(dep_rows, dim=0),
                           torch.cat(dep_atoms, dim=0), natoms)

    results = []
    for base, dbase, l1 in ((0, 0, level1_a), (5, 3, level1_b)):
        e_psi = l1["gamma1i"] * l1["gv"] + acc[:, base]
        dr = deposits[:, dbase:dbase + 3] + acc[:, base + 2:base + 5]
        results.append(dict(energy=torch.sum(e_psi), dr=dr))
    results[1]["self_volume"] = (level1_b["gv"] + acc[:, 10]
                                 + deposits[:, 6])
    return results[0], results[1]
