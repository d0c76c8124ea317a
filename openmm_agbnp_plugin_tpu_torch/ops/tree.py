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
rests on.  A level's valid rows come first, so its segment lengths count
them alone and the sum never reads the padding behind them.

The top-down passes gather parent rows and atom rows at every level through
ops/kernels/rows.py::take_rows (a CUDA kernel on the card, the stock gather
on the CPU), with int32 ids that each topology carries beside its int64
ones (level_bounds).

Capacity overflow is detected and reported (the PanicButton analogue,
OpenCLAGBNPKernels.cpp:3598-3634): the host checks the returned diagnostics
and rebuilds with larger capacities.

Replicas: B replicas of one system are one tree over the disjoint union of
their atoms (atom b N + i is atom i of replica b).  No candidate pair
crosses replicas, so the union's overlap tree is exactly the union of the
replicas' trees, each replica's rows in the order its own build gives them.
`nrep` (1 for one system) makes build_tree hold every level at nrep
times the per-replica capacity and report the counts per replica ([nrep,
7], each against the per-replica capacity, so no level is cut unless some
replica overflows), compact_topology likewise, and the reductions sum the
energy per replica ([nrep]).  One system is a batch of one: its diag and
energies carry the leading [1] axis too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..models.constants import MAX_ORDER, PI, VOLMINA
from .gaussians import atomic_gaussian_exponent, pol_switchfunc, survives
from .kernels.rows import take_rows

# Levels 2..MAX_ORDER are stored; index l in tuples below is level l+2.
NUM_TREE_LEVELS = MAX_ORDER - 1  # 7


# --- collective byte accounting --------------------------------------------
# Every TreeComm / pair-phase collective records its logical kind (the JAX
# package's names: all_gather, psum_scatter, psum) with its operand's shape,
# dtype and bytes, so the communication of one sharded evaluation can be
# read off and set beside the JAX package's log entry by entry.
_COMM_LOG = None


def start_comm_log() -> list:
    """Begin recording every TreeComm/pair-phase collective from now on;
    returns the live list (entries: dict(kind, shape, dtype, bytes,
    ndev))."""
    global _COMM_LOG
    _COMM_LOG = []
    return _COMM_LOG


def stop_comm_log() -> list:
    global _COMM_LOG
    log, _COMM_LOG = _COMM_LOG, None
    return log


def record_comm(kind: str, x, ndev: int):
    if _COMM_LOG is not None:
        _COMM_LOG.append(dict(
            kind=kind, shape=tuple(int(s) for s in x.shape),
            dtype=str(x.dtype).replace("torch.", ""),
            bytes=x.numel() * x.element_size(), ndev=ndev))


def gather_blocks(x, group, size: int):
    """The row blocks x [blk, ...] of every rank of `group`, concatenated in
    rank order: [size blk, ...] (a list all_gather)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


def sum_over_ranks(x, group, size: int):
    """The sum of x over the ranks of `group`, added in rank order from an
    all_gather: every rank holds the same bits whatever order the backend
    would reduce in (the replicated MD state rests on it)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@dataclasses.dataclass(frozen=True)
class TreeComm:
    """Collective hooks that let the fixed-topology passes run on row BLOCKS
    of the level arrays, one block a rank of a torch.distributed process
    group (parallel/sharding.py::sharded_energy_forces; the JAX package's
    TreeComm inside shard_map).

    The downward rescans keep the parent level whole on every rank (each
    level's freshly computed block is gathered), so the per-row parent
    gathers stay local; the upward reductions segment-sum each rank's rows
    into the full parent space and sum across ranks: back to the rank's
    parent block between levels, whole at the atom level, where the results
    (energy, deposits, level-1 accumulators) are needed on every rank.

    group: the process group (None: the default one); rank, size: this
    rank's index in it and its size.
    """

    group: object
    rank: int
    size: int

    def full(self, x):
        """Row block -> the full rows on every rank."""
        record_comm("all_gather", x, self.size)
        return gather_blocks(x, self.group, self.size)

    def reduce_blocks(self, x):
        """Full-space partial sums -> this rank's row block of the total."""
        record_comm("psum_scatter", x, self.size)
        blk = x.shape[0] // self.size
        tot = sum_over_ranks(x, self.group, self.size)
        return tot[self.rank * blk:(self.rank + 1) * blk]

    def reduce_full(self, x):
        """Full-space partial sums -> the total on every rank."""
        record_comm("psum", x, self.size)
        return sum_over_ranks(x, self.group, self.size)


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
    already nondecreasing) and each segment is summed in row order.  A row
    whose id is num_segments is left out: it sorts behind every segment and
    is never read (the padding rows of the tree's deposits)."""
    if not ids_sorted:
        order = torch.argsort(ids, stable=True)
        ids = ids[order]
        x = x[order]
    lengths = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=x.device)
    lengths.index_add_(0, ids.long(), torch.ones_like(ids, dtype=torch.int64))
    return sorted_segment_sum(x, lengths[:num_segments])


def batched_segment_sum(x, ids, num_segments: int):
    """segment_sum of x [..., S, C] by ids [S] in [0, num_segments) along
    the rows' axis: [..., num_segments, C], each leading index (a replica)
    summed apart over the flattened rows with its ids offset by b *
    num_segments.  The rows of one replica keep their order, so replica b
    gets the bits of segment_sum(x[b], ids, num_segments); with no leading
    axis it is segment_sum."""
    lead = tuple(x.shape[:-2])
    if not lead:
        return segment_sum(x, ids, num_segments)
    nb = int(np.prod(lead))
    off = num_segments * torch.arange(nb, device=x.device)[:, None]
    out = segment_sum(x.reshape(nb * x.shape[-2], x.shape[-1]),
                      (ids[None, :] + off).reshape(-1), nb * num_segments)
    return out.reshape(lead + (num_segments, x.shape[-1]))


def sorted_segment_sum(x, lengths):
    """Sums of consecutive runs of the rows of x [R, C]: segment s is the
    next lengths[s] rows, added in row order; the rows past the lengths' sum
    (a level's padding) are not read."""
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def sorted_lengths(ids, valid, num_segments: int):
    """Rows of each segment among the valid rows of a level: [num_segments]
    int64, for sorted_segment_sum.

    The valid rows must come first (every constructor here packs them so)
    with nondecreasing ids: a sorted segment sum takes its rows one segment
    after another, so an invalid row among the valid ones would push every
    later row into the wrong segment.  A level that breaks the rule raises:
    a ValueError on the CPU; on a CUDA device, where reading the answer
    would stall the host, a device-side assertion that the next
    synchronisation reports."""
    prefix = torch.all(valid[1:] <= valid[:-1])
    rising = torch.all((ids[1:] >= ids[:-1]) | ~valid[1:])
    if valid.device.type == "cpu":
        if not bool(prefix):
            raise ValueError("a level's valid rows must come before its "
                             "invalid ones for a sorted segment sum")
        if not bool(rising):
            raise ValueError("the ids of a level's valid rows must not "
                             "decrease for a sorted segment sum")
    else:
        torch._assert_async(prefix & rising)
    lengths = torch.zeros(num_segments, dtype=torch.int64, device=ids.device)
    return lengths.index_add_(0, ids.long(), valid.long())


def level_bounds(pmono, atom, valid, num_parents: int, natoms: int):
    """What the passes need of a parent-sorted level beside its indices,
    made once per topology: pmono, the monotone segment-id vector of the
    packed layout (invalid slots carry an id that no consumer reads past the
    mask); lengths, the valid rows under each parent (sorted_lengths);
    pmono32 and atom32, the parent and atom ids as the int32 that the row
    gather takes; atom_dep, the atom each slot deposits on, natoms (the id
    segment_sum leaves out) on invalid slots."""
    return dict(pmono=pmono,
                lengths=sorted_lengths(pmono, valid, num_parents),
                pmono32=pmono.to(torch.int32),
                atom32=atom.to(torch.int32).contiguous(),
                atom_dep=torch.where(valid, atom, natoms))


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
    """Indices of the True entries of a mask along its last axis, in order,
    padded or cut to `size` without a host sync (the tail past the True
    count is junk that callers mask).  A mask [B, K] gives each row's
    indices (the MS particles of each replica)."""
    idx = torch.argsort((~mask).to(torch.int32), dim=-1,
                        stable=True)[..., :size]
    if idx.shape[-1] < size:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1]
                                            + (size - idx.shape[-1],))],
                        dim=-1)
    return idx


def _compact(mask, cand_dat, cand_ints, cap, parent_cap, natoms):
    """Pack masked candidates into a fixed-capacity level, grouped by parent
    (ids below parent_cap) and volume-sorted within each group
    (add_children's descending-volume sibling order, gaussvol.cpp:169-171)."""
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
    lvl["bnd"] = level_bounds(
        torch.cummax(torch.where(valid, lvl["parent"], 0), dim=0).values,
        lvl["atom"], valid, parent_cap, natoms)
    return lvl, count


def _survive_mask(dat, sgvol, relax):
    """Node survival.  relax=None is the reference pruning (switched
    volume > FLT_MIN, gaussvol.cpp:233); relax < 1 keeps the nodes whose
    raw volume is above VOLMINA * relax as zero-contribution "birth
    margin" rows, so a stale topology stays exact while volumes drift
    across the switching threshold (JAX ops/tree.py::_survive_mask)."""
    if relax is None:
        return survives(sgvol)
    return dat[..., 0] > VOLMINA * relax


def _pair_candidates(level1, pairs_i, pairs_j, pairs_valid=None,
                     relax=None):
    """2-body overlaps for the given (i, j) candidate pairs (i-major order)."""
    at = level1["_at"]
    si = at[pairs_i]
    dat, sgvol = _cand_dat(si[:, 0], si[:, 1], si[:, 2:5], si[:, 5],
                           at[pairs_j])
    mask = _survive_mask(dat, sgvol, relax)
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

    Returns (row_of_slot, off_of_slot, valid, count, cnt) where off is the
    within-row candidate offset; row_of_slot is also pmono, the monotone
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
    return row, off, valid, count, cnt


def _build_sibling_level(prev_lvl, prev_a6, level1, offs, cap, relax=None):
    """Next-level build: the partner of each node is taken from a window of
    the next `offs` rows of the same (parent-grouped) level; partners
    sharing the parent form the sibling-pair candidates.  Returns
    (lvl, a6, cnt) with a6 the atomic rows of each node's atom and cnt the
    surviving children of each row of the previous level."""
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
    mask = pair_ok & _survive_mask(dat, sgvol, relax)

    row, off, valid, _, cnt = _compact_rows(dat[:, :, 5], mask, cap)
    idx = row * offs + off
    out_dat = torch.where(valid[:, None],
                          dat.reshape(cap_prev * offs, _D)[idx], 0.0)
    atom2 = torch.where(valid, win_i[:, :, 0].reshape(-1)[idx], 0)
    ints = torch.stack([atom2, torch.where(valid, row, 0)], dim=1)
    a6 = level1["_at"][atom2]
    lvl = _level_views(out_dat, ints, valid)
    lvl["bnd"] = level_bounds(row, atom2, valid, cap_prev,
                              level1["gv"].shape[0])
    return lvl, a6, cnt


def _build_pair_level(level1, pj2d, pv2d, cap, relax=None):
    """Level-2 build from a fixed-width i-major neighbor grid [N, kmax]
    (half_neighbor_pairs layout): the i side is a broadcast and compaction
    is row-structured.  Returns (lvl, a6, cnt), cnt the surviving pairs of
    each atom."""
    at = level1["_at"]
    n, kmax = pj2d.shape
    a = at[pj2d]  # [n, kmax, 6]
    dat, sgvol = _cand_dat(at[:, 0:1], at[:, 1:2], at[:, None, 2:5],
                           at[:, 5:6], a)
    mask = _survive_mask(dat, sgvol, relax)
    if pv2d is not None:
        mask = mask & pv2d

    row, off, valid, _, cnt = _compact_rows(dat[:, :, 5], mask, cap)
    idx = row * kmax + off
    out_dat = torch.where(valid[:, None], dat.reshape(n * kmax, _D)[idx], 0.0)
    atom2 = torch.where(valid, pj2d.reshape(-1)[idx].long(), 0)
    ints = torch.stack([atom2, torch.where(valid, row, 0)], dim=1)
    a6 = at[atom2]
    lvl = _level_views(out_dat, ints, valid)
    lvl["bnd"] = level_bounds(row, atom2, valid, n, n)
    return lvl, a6, cnt


def _children(level, parent_cap):
    """Surviving children under each parent."""
    cnt = torch.zeros(parent_cap, dtype=torch.int64,
                      device=level["valid"].device)
    return cnt.index_add_(0, level["parent"], level["valid"].long())


def replica_sum(x, rep, nrep: int):
    """Integer per-replica sums [nrep] of x over rows whose replica is rep
    (exact: integer adds in any order)."""
    return torch.zeros(nrep, dtype=torch.int64, device=x.device).index_add_(
        0, rep, x.long())


def replica_max(x, rep, nrep: int):
    """Integer per-replica maxima [nrep] of x (zero for a replica without
    rows)."""
    return torch.zeros(nrep, dtype=torch.int64,
                       device=x.device).scatter_reduce(0, rep, x.long(),
                                                       "amax")


def build_tree(level1, pairs_i, pairs_j, caps: TreeCaps, pairs_valid=None,
               pair_rows: bool = False, nrep: int = 1, relax=None):
    """Builds all overlap levels 2..MAX_ORDER.

    pairs_i/pairs_j: candidate 2-body pairs (i < j), i-major order — from an
    all-pairs enumeration or a padded neighbor list (pairs_valid masks the
    list's padding slots; with pair_rows the list is the fixed-width
    [N, kmax] grid of half_neighbor_pairs and level 2 takes the row path).
    Returns (levels, diag) where diag carries per-level counts and overflow
    indicators as device tensors.

    nrep: level1 is the disjoint union of nrep replicas (equal atom
    counts) and no candidate pair crosses them; caps are per replica and
    each level holds nrep times as many rows.  Every leaf of the diag has
    a leading [nrep] axis: the counts and sibling maxima of each replica
    (before any cut), against the per-replica caps and windows.

    relax: None prunes as the reference does; a value below 1 keeps the
    birth-margin rows of _survive_mask at every level (the rebuild-window
    MD's topology_relax).
    """
    natoms = level1["gv"].shape[0]
    per = natoms // nrep
    dev = level1["gv"].device
    levels = []
    counts = []
    sib_max = []
    lcaps = tuple(c * nrep for c in caps.caps)

    def rep_of(atom):
        return torch.div(atom, per, rounding_mode="floor")

    if pair_rows:
        pj2d = pairs_j.reshape(natoms, -1)
        pv2d = None if pairs_valid is None else pairs_valid.reshape(natoms, -1)
        lvl, a6, cnt = _build_pair_level(level1, pj2d, pv2d, lcaps[0],
                                         relax)
        count = replica_sum(cnt, rep_of(torch.arange(natoms, device=dev)),
                            nrep)
    else:
        dat, cints, mask = _pair_candidates(level1, pairs_i, pairs_j,
                                            pairs_valid, relax)
        lvl, _ = _compact(mask, dat, cints, lcaps[0], natoms, natoms)
        a6 = level1["_at"][lvl["atom"]]
        cnt = _children(lvl, natoms)
        count = replica_sum(mask, rep_of(pairs_i.long()), nrep)
    # level 2's parents are the atoms
    msib = replica_max(cnt, rep_of(torch.arange(natoms, device=dev)), nrep)
    levels.append(lvl)
    counts.append(count)
    sib_max.append(msib)

    for l in range(1, NUM_TREE_LEVELS):
        prev = levels[-1]
        lvl, a6, cnt = _build_sibling_level(
            prev, a6, level1, caps.offs[l - 1], lcaps[l], relax)
        # each row of the previous level is a node of its atom's replica
        # (invalid rows have no children)
        rows = rep_of(prev["atom"])
        count = replica_sum(cnt, rows, nrep)
        msib = replica_max(cnt, rows, nrep)
        levels.append(lvl)
        counts.append(count)
        sib_max.append(msib)

    diag = dict(
        counts=torch.stack(counts, dim=-1).long(),
        max_siblings=torch.stack(sib_max, dim=-1).long(),
        **caps_rows(caps, nrep, dev),
    )
    return tuple(levels), diag


def caps_rows(caps: TreeCaps, nrep: int, device) -> dict:
    """The diag's capacity leaves, caps and sibling windows (offs), one
    [7] row per replica."""
    return dict(caps=torch.tensor(caps.caps, device=device).repeat(nrep, 1),
                offs=torch.tensor(caps.offs + (0,),
                                  device=device).repeat(nrep, 1))


def replica_counts(levels, nrep: int, natoms: int):
    """Valid rows of each level per replica, [nrep, 7], of a union tree
    over nrep replicas of natoms atoms each (the counts a fixed topology
    carries)."""
    return torch.stack([replica_sum(
        l["valid"], torch.div(l["atom"], natoms, rounding_mode="floor"),
        nrep) for l in levels], dim=-1)


def merge_counts(a, b):
    """Elementwise max of two overflow-count vectors, zero-padding the
    shorter (along the last axis: per-replica rows [R, C] merge row by
    row)."""
    a = a.long()
    b = b.long()
    if a.shape[-1] < b.shape[-1]:
        a = torch.nn.functional.pad(a, (0, b.shape[-1] - a.shape[-1]))
    elif b.shape[-1] < a.shape[-1]:
        b = torch.nn.functional.pad(b, (0, a.shape[-1] - b.shape[-1]))
    return torch.maximum(a, b)


def check_overflow(diag) -> dict:
    """Host-side PanicButton check of one system's diag (levels on the
    last axis). Returns numpy bools per level.  The diag's leaves may be
    tensors or numpy arrays (batched_diag_max's)."""
    def host(k):
        return np.asarray(torch.as_tensor(diag[k]).cpu())

    counts, caps, sibs, offs = (host(k) for k in ("counts", "caps",
                                                 "max_siblings", "offs"))
    cap_overflow = counts > caps
    sib_overflow = np.zeros_like(cap_overflow)
    sib_overflow[..., :-1] = (sibs[..., :-1] - 1) > offs[..., :-1]
    return dict(cap_overflow=cap_overflow, sib_overflow=sib_overflow,
                any=bool(cap_overflow.any() or sib_overflow.any()))


def _parent_gather(x, lvl):
    """Parent rows x[parent] of a level (x [P, C] or [P]).  The monotone
    segment ids (pmono) stand in for the raw parent indices: identical for
    every valid slot; invalid slots read junk that every consumer masks."""
    return take_rows(x, lvl["bnd"]["pmono32"])


def _atom_gather(x, lvl):
    """Rows x[atom] of each slot's last atom (x [N, C] or [N])."""
    return take_rows(x, lvl["bnd"]["atom32"])


def _upward_segment_sum(x, lvl, num_parents, comm=None):
    """The per-level child -> parent reduction of x [cap, C], over the
    level's valid rows.  With comm, x is a rank's row block of the level:
    its rows go into the full parent space by their own monotone parent ids
    (a sorted segment sum, no float atomics; the block's invalid rows carry
    zeros), for the caller's cross-rank reduction."""
    if comm is not None:
        return segment_sum(x, lvl["bnd"]["pmono"], num_parents,
                           ids_sorted=True)
    lengths = lvl["bnd"]["lengths"]
    if lengths.shape != (num_parents,):
        raise ValueError(f"level bounds for {lengths.shape[0]} parents, "
                         f"expected {num_parents}")
    return sorted_segment_sum(x, lengths)


def tree_topology(levels):
    """Extract the shape-static topology (indices + validity) of a built
    tree; rescan_volumes reconstructs full levels from it, so the MD loop
    carries just these int arrays between rebuilds."""
    return tuple(dict(_ints=l["_ints"], valid=l["valid"], atom=l["atom"],
                      parent=l["parent"], bnd=l["bnd"]) for l in levels)


def compact_topology(levels, caps, relax: float = 0.5, nrep: int = 1):
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

    nrep: a union tree over nrep replicas (build_tree(nrep=)); caps are per
    replica, each level holds nrep times as many rows, and counts are
    [nrep, 7], each replica's kept rows.
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

    natoms = prev_cap = levels[0]["bnd"]["lengths"].shape[0]
    counts = torch.stack([torch.sum(k) for k in keep])
    rep_counts = replica_counts(
        [dict(valid=k, atom=l["atom"]) for k, l in zip(keep, levels)], nrep,
        natoms // nrep)
    out = []
    prev_remap = None  # old parent index -> compact slot of previous level
    for li, (lvl, kp) in enumerate(zip(levels, keep)):
        cap = max(int(caps[li]), 8) * nrep
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
                        bnd=level_bounds(torch.cummax(parent, dim=0).values,
                                         atom, valid, prev_cap, natoms)))
        prev_remap = torch.cumsum(kp.to(torch.int64), dim=0) - 1
        prev_cap = cap
    return tuple(out), rep_counts


def rescan_volumes(levels, level1, comm: TreeComm | None = None):
    """Recompute all node volumes/Gaussians on the fixed topology (the
    analogue of rescan_tree_v, gaussvol.cpp:254-327): new level-1 data, same
    parent/atom indices, no re-pruning.  Accepts full levels or a
    tree_topology() result.  With comm, the levels are this rank's row
    blocks (parallel/sharding.py::_shard_topology); each level's block is
    gathered whole so the next level's parent gathers see every row."""
    new_levels = []
    # level-1 "dat" is the packed atomic table; map its columns to the same
    # (gv, ga, gc, gamma) positions the level matrices use
    prev_dat, cols = level1["_at"], (0, 1, 2, 5)
    for lvl in levels:
        sp = _parent_gather(prev_dat, lvl)
        g0, g1, gc0, gg = cols
        dat, _ = _cand_dat(sp[:, g0], sp[:, g1], sp[:, gc0:gc0 + 3],
                           sp[:, gg], _atom_gather(level1["_at"], lvl))
        # zero invalid rows like the build's _compact
        dat = dat * lvl["valid"][:, None].to(dat.dtype)
        nl = _level_views(dat, lvl["_ints"], lvl["valid"])
        nl["bnd"] = lvl["bnd"]
        new_levels.append(nl)
        prev_dat = dat if comm is None else comm.full(dat)
        cols = (0, 1, 2, 11)
    return tuple(new_levels)


def rescan_gammas(levels, level1, comm: TreeComm | None = None):
    """Propagate new per-atom gammas down the fixed topology
    (rescan_tree_g, gaussvol.cpp:330-372); with comm, on row blocks as
    rescan_volumes."""
    gam = level1["gamma1i"]
    new_levels = []
    pg = gam
    for lvl in levels:
        g = _parent_gather(pg, lvl) + _atom_gather(gam, lvl)
        new_levels.append({**lvl, "gamma1i": g})
        pg = g if comm is None else comm.full(g)
    return tuple(new_levels)


def reduce_tree(levels, level1, with_selfvol: bool = True,
                with_dv: bool = False, nrep: int = 1,
                comm: TreeComm | None = None):
    """Bottom-up reduction: energy, gradients, self volumes.

    The flattened form of compute_volume_underslot2_r (gaussvol.cpp:400-519):
    for each level from the deepest up, per-node subtree accumulators are
    combined with the children's segment-summed accumulators, deposited onto
    the node's last atom, transformed by the (dv1, dvv1, a1/a1i) recursion
    and passed to the parents.  The gamma-weighted energy family carries the
    full (psi, F, P) chain (5 channels); the self-volume family only its psi
    scalar.  All channels ride one [cap, C] matrix: one upward segment sum
    per level and one atom-deposit segment sum at the end.

    with_dv adds the dv channel, V_i dE/dV_i of each atomic volume: an
    n-body Gaussian product volume is linear in each constituent volume,
    so each node deposits gv * e_f on its last atom (the AGBNP2 MS tree's
    free-volume chain, JAX ops/tree.py::reduce_tree).

    Returns dict(energy, dr[, self_volume][, dv]); dr is the energy
    gradient wrt positions (negate for force); the energy is [nrep], each
    replica's sum (a union tree over nrep replicas).

    With comm, the levels are this rank's row blocks: each level's upward
    partial sums over the full parent space are summed across ranks, back
    to the rank's parent block between levels and whole at the atom level,
    as are the deposits, so every result is whole on every rank.
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
        if with_dv:
            dep_cols.append((lvl["gv"] * e_f)[:, None])
        dep_rows.append(torch.cat(dep_cols, dim=1) * vmask[:, None])
        dep_atoms.append(lvl["bnd"]["atom_dep"])

        p_out = lvl["dv1"] * e_f[:, None] + e_p * c2p[:, None]
        up = torch.cat([
            tot[:, 0:1],                       # e_psi passes through
            (lvl["dvv1"] * e_f)[:, None],      # e_f
            p_out,                             # e_p
            tot[:, 5:],                        # sv psi passes through
        ], dim=1) * vmask[:, None]
        acc = _reduce_up(up, levels, l, natoms, comm)

    deposits = _deposits(dep_rows, dep_atoms, natoms, comm)

    # level 1 (atoms): volcoeff = volcoeffp = 1, sfp = 1, dvv1 = 1, dv1 = 0,
    # c2 = 1, c2p = 0 (gaussvol.cpp:413-435 with level == 1)
    gamma = level1["gamma1i"]
    vol = level1["gv"]
    e_psi = gamma * vol + acc[:, 0]
    dr = deposits[:, 0:3] + acc[:, 2:5]
    result = dict(energy=_energy(e_psi, nrep), dr=dr)
    col = 3
    if with_selfvol:
        result["self_volume"] = vol + acc[:, 5] + deposits[:, col]
        col += 1
    if with_dv:
        result["dv"] = vol * (gamma + acc[:, 1]) + deposits[:, col]
    return result


def _reduce_up(up, levels, l, natoms: int, comm):
    """Level l's upward sums into its parents' accumulators (the atoms at
    l = 0); with comm, summed across ranks: the rank's parent block, or the
    whole atom rows at l = 0."""
    nmul = 1 if comm is None else comm.size
    num_parents = natoms if l == 0 else (
        levels[l - 1]["valid"].shape[0] * nmul)
    acc = _upward_segment_sum(up, levels[l], num_parents, comm)
    if comm is not None:
        acc = comm.reduce_full(acc) if l == 0 else comm.reduce_blocks(acc)
    return acc


def _deposits(dep_rows, dep_atoms, natoms: int, comm):
    """Every level's deposits summed onto their atoms (whole on every rank
    with comm)."""
    deposits = segment_sum(torch.cat(dep_rows, dim=0),
                           torch.cat(dep_atoms, dim=0), natoms)
    return deposits if comm is None else comm.reduce_full(deposits)


def _energy(e_psi, nrep: int):
    """The energy of per-atom terms, each replica's sum [nrep]."""
    return torch.sum(e_psi.reshape(nrep, -1), dim=1)


def rescan_volumes2(levels, level1_a, level1_b,
                    comm: TreeComm | None = None):
    """Fixed-topology volume rescan for TWO parameterizations at once (the
    cavity term's large and vdW radii, ReferenceAGBNPKernels.cpp:293-384):
    one parent gather of the packed [cap, 2*_D] matrix per level.  Invalid
    rows carry finite junk that every consumer masks.  With comm, on row
    blocks as rescan_volumes.

    Returns (levels_a, levels_b).
    """
    out_a, out_b = [], []
    at2 = torch.cat([level1_a["_at"], level1_b["_at"]], dim=1)  # [N, 12]
    prev = at2
    prev_cols = ((0, 1, 2, 5), (6, 7, 8, 11))  # (gv, ga, gc0, gamma) per half
    for lvl in levels:
        sp = _parent_gather(prev, lvl)
        a2 = _atom_gather(at2, lvl)
        (ga0, ga1, gac, gag), (gb0, gb1, gbc, gbg) = prev_cols
        dat_a, _ = _cand_dat(sp[:, ga0], sp[:, ga1], sp[:, gac:gac + 3],
                             sp[:, gag], a2[:, 0:6])
        dat_b, _ = _cand_dat(sp[:, gb0], sp[:, gb1], sp[:, gbc:gbc + 3],
                             sp[:, gbg], a2[:, 6:12])
        la = _level_views(dat_a, lvl["_ints"], lvl["valid"])
        lb = _level_views(dat_b, lvl["_ints"], lvl["valid"])
        la["bnd"] = lb["bnd"] = lvl["bnd"]
        out_a.append(la)
        out_b.append(lb)
        prev = torch.cat([dat_a, dat_b], dim=1)  # [cap, 2*_D]
        if comm is not None:
            prev = comm.full(prev)
        prev_cols = ((0, 1, 2, 11), (_D, _D + 1, _D + 2, _D + 11))
    return tuple(out_a), tuple(out_b)


def reduce_tree2(levels_a, levels_b, level1_a, level1_b,
                 with_selfvol_b: bool = True, with_selfvol_a: bool = False,
                 nrep: int = 1, comm: TreeComm | None = None):
    """Bottom-up reduction of two same-topology trees in one sweep.

    Packs both trees' accumulator channels into one matrix so each level
    runs a single upward segment sum; deposits are batched into one.
    Returns (result_a, result_b) like reduce_tree(with_selfvol=
    with_selfvol_a) and reduce_tree(with_selfvol=with_selfvol_b), energies
    per replica with nrep.  With comm, on row blocks as reduce_tree.
    """
    natoms = level1_a["gv"].shape[0]
    dtype = level1_a["gv"].dtype

    acc = None
    dep_rows = []
    dep_atoms = []
    # channels past the two 5-channel energy families: sv_b, then sv_a
    i_svb = 10
    i_sva = 10 + (1 if with_selfvol_b else 0)

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
        if with_selfvol_b:
            cols.append(volcoeffp * lb["volume"])
        if with_selfvol_a:
            cols.append(volcoeffp * la["volume"])
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
        # the self-volume psi channels deposit and pass up as they are
        dep_cols.append(tot[:, 10:])
        ups.append(tot[:, 10:])
        dep_rows.append(torch.cat(dep_cols, dim=1) * vmask[:, None])
        dep_atoms.append(la["bnd"]["atom_dep"])

        up = torch.cat(ups, dim=1) * vmask[:, None]
        acc = _reduce_up(up, levels_a, l, natoms, comm)

    deposits = _deposits(dep_rows, dep_atoms, natoms, comm)

    results = []
    for base, dbase, l1 in ((0, 0, level1_a), (5, 3, level1_b)):
        e_psi = l1["gamma1i"] * l1["gv"] + acc[:, base]
        dr = deposits[:, dbase:dbase + 3] + acc[:, base + 2:base + 5]
        results.append(dict(energy=_energy(e_psi, nrep), dr=dr))
    if with_selfvol_b:
        results[1]["self_volume"] = (level1_b["gv"] + acc[:, i_svb]
                                     + deposits[:, 6])
    if with_selfvol_a:
        results[0]["self_volume"] = (level1_a["gv"] + acc[:, i_sva]
                                     + deposits[:, 6 + i_sva - 10])
    return results[0], results[1]
