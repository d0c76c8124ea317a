"""AGBNP2 (version 2): energy in PyTorch, forces by autograd through three
analytic reverse rules.

Counterpart of the JAX package's models/agbnp2_jax.py.  The second
(molecular-surface) overlap tree reuses the flattened-tree machinery of
ops/tree.py: MS water-probe particles are made from a padded list of heavy
candidate pairs, their free volumes come from a dense [cap_ms, N] (or a
neighbor-bounded [cap_ms, k]) Gaussian subtraction, and both MS passes (vdW
and large free volumes) run over one built topology (reference
ReferenceAGBNPKernels.cpp:797-1793).

Forces are -d(energy)/d(positions) by torch.autograd.  Where JAX has a
custom VJP, this module has a torch.autograd.Function whose backward is the
hand chain instead of autograd through the sweeps:

  _AtomicCavity  both atomic tree passes; backward = one gamma rescan of
                 each parameterization (rescan_gammas + reduce_tree2)
  _MSCavity      both MS tree passes; backward = gamma rescans with the
                 dv channel (reduce_tree(with_dv=True)), which also gives
                 the cotangents of the MS free volumes
  PairCavity     the GB/vdW pair phases; backward = the phases' own
                 pair_force and W + U = dE/d(s_factor)

The pair phases run through agbnp_torch._pair_phases_kernel (the dense
CUDA kernels #1-#3 on a GPU, their twins on the CPU) or, with
pair_kernel=False, through the plain [N, N] phases of ops/born.py.  Tree
builds carry no gradient: they only pick the topology that the Functions
rescan.

Replicas (AGBNP2Model.batched_energy_forces, JAX's vmapped energy): B
conformations [B, N, 3] of one system evaluate as one batch.  Each
replica's MS candidates compact into its own cap_ms particles; the atomic
tree and the MS tree are each built once over the disjoint union of the
replicas' atoms (b N + i) and MS particles (b cap_ms + k), with the
capacities per replica (ops/tree.py, nrep); the Functions return energies
[B] and scale each row's gamma rescan by its own replica's cotangent; the
pair phases run the kernels' replica axis, one launch for the batch.  One
system is a batch of one, its axis dropped.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from ..ops import tree as T
from ..ops.gaussians import pol_switchfunc
from ..ops.kernels import pairs as PK
from ..ops.neighbors import half_neighbor_pairs, tree_pair_cutoff
from ..utils import profiling
from .agbnp_torch import AGBNPModel, _pair_phases_kernel, \
    _pair_phases_plain, arrays_from_numpy, batched_diag_max, \
    prepare_arrays, union_arrays
from . import capacity
from .constants import AGBNP2_RADIUS_INCREMENT, ANG3, KFC, PI, \
    SOLVENT_RADIUS, VOLMINA, sphere_volume
from .params import AGBNPParams

VOLMINMSA = 0.25 * ANG3
VOLMINMSB = 1.00 * ANG3
VOL_COEFF = 0.17
FLT_MIN = 1.1754943508222875e-38


def _ms_switch(v):
    """Quintic switch on the MS window (VOLMINMSA..VOLMINMSB)."""
    u = torch.clamp((v - VOLMINMSA) / (VOLMINMSB - VOLMINMSA), 0.0, 1.0)
    return u ** 3 * (10.0 - 15.0 * u + 6.0 * u ** 2)


def ms_pair_cutoff(radii_vdw) -> float:
    """Distance beyond which a heavy pair cannot spawn an MS particle."""
    radw = SOLVENT_RADIUS
    rmax = float(np.max(np.asarray(radii_vdw)))
    q = rmax / radw
    volms0 = VOL_COEFF * q * q * sphere_volume(radw)
    sigma = 0.5 * math.sqrt(q) * radw
    dms = 2 * rmax + 0.5 * radw
    if volms0 <= VOLMINMSA:
        return dms
    return dms + sigma * math.sqrt(2.0 * math.log(volms0 / VOLMINMSA)) + 0.05


def _take(x, ids, batched: bool):
    """Each replica's own entries: x[ids] for one system, x[b, ids[b]] for
    replicas (x [B, M, ...], ids [B, ...]).  Advanced indexing, whose
    backward is PyTorch's sorted index_put (no float atomics)."""
    if not batched:
        return x[ids]
    b = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (ids.dim() - 1))
    return x[b, ids]


def ms_particles(pos, radii_vdw, pi, pj, pvalid, cap_ms: int, idx=None,
                 count=None):
    """Padded MS particle set from heavy candidate pairs (reference
    cpp:895-941).  Returns dict(pos, vol0, p1, p2, valid, idx, count).

    pos [N, 3] with candidates pi, pj, pvalid [K]; or replicas pos [B, N,
    3] with [B, K] candidates in each replica's own atom ids, every result
    then [B, ...] (each replica compacted into its own cap_ms slots, count
    [B]).  With idx/count (the frozen compaction of an earlier build: the
    stale-topology MD window) the survivors are kept and only their
    geometry is recomputed at the current positions."""
    radw = SOLVENT_RADIUS
    volw = sphere_volume(radw)
    r1 = radii_vdw[pi]
    r2 = radii_vdw[pj]
    q = torch.sqrt(r1 * r2) / radw
    bt = pos.dim() == 3
    pos_i, pos_j = _take(pos, pi, bt), _take(pos, pj, bt)
    dist = pos_j - pos_i
    d = torch.sqrt(torch.sum(dist * dist, dim=-1) + 1e-30)
    dms = r1 + r2 + 0.5 * radw
    volms0 = VOL_COEFF * q * q * volw
    sigma = 0.5 * torch.sqrt(q) * radw
    volms = volms0 * torch.exp(-0.5 * (d - dms) ** 2 / (sigma * sigma))
    volmsw = volms * _ms_switch(volms)
    fms = 0.5 * (1.0 + (r1 - r2) / d)
    posms = pos_j * fms[..., None] + pos_i * (1.0 - fms)[..., None]

    if idx is None:
        mask = pvalid & (volmsw > FLT_MIN)
        count = torch.sum(mask, dim=-1)
        idx = T._nonzero_padded(mask, cap_ms)
    valid = torch.arange(cap_ms, device=pos.device) < count[..., None]
    return dict(
        pos=torch.where(valid[..., None], _take(posms, idx, bt), 0.0),
        vol0=torch.where(valid, _take(volmsw, idx, bt), 0.0),
        p1=torch.where(valid, _take(pi, idx, bt), 0).long(),
        p2=torch.where(valid, _take(pj, idx, bt), 0).long(),
        valid=valid, count=count, idx=idx)


def ms_subtraction_horizon(radii_vdw, radii_large, margin: float = 0.1):
    """Static distance beyond which no atom can contribute to any MS free
    volume: the subtracted overlap is switched to exact 0 below VOLMINA, and
    the Gaussian product with the largest possible prefactor (max MS seed
    volume x max atomic self volume) falls below VOLMINA past it.  `margin`
    absorbs drift over a stale-topology MD window."""
    radw = SOLVENT_RADIUS
    rmax_vdw = float(np.max(np.asarray(radii_vdw)))
    vol0_max = VOL_COEFF * (rmax_vdw / radw) ** 2 * sphere_volume(radw)
    ams = KFC / (radw * radw)
    dmax = 0.0
    for r in np.unique(np.asarray(radii_large)):
        ai = KFC / (r * r)
        df = ams * ai / (ams + ai)
        g0 = vol0_max * sphere_volume(r) / (PI / df) ** 1.5
        if g0 > VOLMINA:
            dmax = max(dmax, math.sqrt(math.log(g0 / VOLMINA) / df))
    return dmax + margin


def ms_atom_neighbors(ms_pos, ms_valid, pos, heavy, rcut: float, k: int):
    """Per-MS-particle padded list of the heavy atoms within `rcut` (the
    subtraction horizon): [cap_ms, k] indices and validity, and the most
    in range of one particle (> k means truncation: an overflow).  Replicas
    (ms_pos [B, cap_ms, 3] against pos [B, N, 3]): each particle's list
    within its own replica, [B, cap_ms, k], the most [B]."""
    dist = pos[..., None, :, :] - ms_pos[..., :, None, :]
    d2 = torch.sum(dist * dist, dim=-1)
    ok = heavy & (d2 < rcut * rcut) & ms_valid[..., None]
    order = torch.argsort((~ok).to(torch.int8), dim=-1, stable=True)[..., :k]
    nvalid = torch.gather(ok, -1, order)
    return order, nvalid, torch.amax(torch.sum(ok, dim=-1), dim=-1)


def ms_free_volumes(ms, pos, radii, self_volume, ishydrogen, nbr=None):
    """Subtract self-volume-weighted atomic Gaussians from each MS sphere
    (reference cpp:1013-1048); the subtracted overlaps take the atomic
    switch, the free volume the MS one.  nbr = (idx [cap_ms, k], valid)
    bounds the subtraction to the atoms inside the static horizon (exact:
    every excluded overlap is switched to 0); without it, the dense
    [cap_ms, N] form.  Replicas: ms's arrays [B, cap_ms, ...] against pos
    [B, N, 3] and self_volume [B, N], each replica's particles against its
    own atoms; radii and ishydrogen [N] are shared."""
    ams = KFC / (SOLVENT_RADIUS * SOLVENT_RADIUS)
    bt = pos.dim() == 3
    if nbr is not None:
        idx, nvalid = nbr
        dist = _take(pos, idx, bt) - ms["pos"][..., :, None, :]
        d2 = torch.sum(dist * dist, dim=-1)
        ai = KFC / (radii[idx] * radii[idx])
        df = ams * ai / (ams + ai)
        gvol = (ms["vol0"][..., None] * _take(self_volume, idx, bt)
                / (PI / df) ** 1.5) * torch.exp(-df * d2)
        sub_mask = (nvalid & (idx != ms["p1"][..., None])
                    & (idx != ms["p2"][..., None]))
    else:
        ai = KFC / (radii * radii)
        dist = pos[..., None, :, :] - ms["pos"][..., :, None, :]
        d2 = torch.sum(dist * dist, dim=-1)
        df = ams * ai / (ams + ai)
        gvol = (ms["vol0"][..., None] * self_volume[..., None, :]
                / (PI / df) ** 1.5) * torch.exp(-df * d2)
        atom = torch.arange(pos.shape[-2], device=pos.device)
        sub_mask = ((ishydrogen == 0) & (atom != ms["p1"][..., None])
                    & (atom != ms["p2"][..., None]))
    s, _ = pol_switchfunc(gvol)
    fv = ms["vol0"] - torch.sum(torch.where(sub_mask, s * gvol, 0.0), dim=-1)
    return fv * _ms_switch(fv) * ms["valid"].to(fv.dtype)


def _atomic_level1(pos, lvl1_args):
    rl, vl, rv, vv, gdr, ish = lvl1_args
    return (T.make_level1(pos, rl, vl, gdr, ish),
            T.make_level1(pos, rv, vv, -gdr, ish))


class _AtomicCavity(torch.autograd.Function):
    """Both atomic cavity passes over a fixed topology of the replicas'
    union (nrep replicas, pos [nrep N, 3]): (E1 [nrep], E2 [nrep], self
    volumes at the large radii, at the vdW radii).

    Backward: d/dpos [g1 . E1 + g2 . E2 + w_l . sv_large + w_v . sv_vdw]
    is one gamma rescan of each parameterization with gammas g1[rep]
    gamma/roffset + w_l and -g2[rep] gamma/roffset + w_v, each row scaled
    by its own replica's cotangent (the reduction is linear in the
    per-atom gammas, and E(gamma = w) = w . sv: the identity behind the
    reference's gamma-rescan force passes, ReferenceAGBNPKernels.cpp:
    713-747).  Only positions get a gradient."""

    @staticmethod
    def forward(ctx, pos, lvl1_args, topo, nrep):
        lvl1_l, lvl1_v = _atomic_level1(pos, lvl1_args)
        levels_l, levels_v = T.rescan_volumes2(topo, lvl1_l, lvl1_v)
        red_l, red_v = T.reduce_tree2(levels_l, levels_v, lvl1_l, lvl1_v,
                                      with_selfvol_b=True,
                                      with_selfvol_a=True, nrep=nrep)
        ctx.rescanned = (levels_l, levels_v, lvl1_l, lvl1_v, lvl1_args[4])
        return (red_l["energy"], red_v["energy"], red_l["self_volume"],
                red_v["self_volume"])

    @staticmethod
    def backward(ctx, g1, g2, w_l, w_v):
        with profiling.span("eval.tree"):
            levels_l, levels_v, lvl1_l, lvl1_v, gdr = ctx.rescanned
            rows = gdr.shape[0] // g1.shape[0]
            gam_l = {**lvl1_l,
                     "gamma1i": g1.repeat_interleave(rows) * gdr + w_l}
            gam_v = {**lvl1_v,
                     "gamma1i": -g2.repeat_interleave(rows) * gdr + w_v}
            red_l, red_v = T.reduce_tree2(T.rescan_gammas(levels_l, gam_l),
                                          T.rescan_gammas(levels_v, gam_v),
                                          gam_l, gam_v, with_selfvol_b=False)
            return red_l["dr"] + red_v["dr"], None, None, None


def _ms_level1(ms_pos, fv_vdw, fv_large, gamma_ms, ish_ms):
    radv = torch.full_like(fv_vdw, SOLVENT_RADIUS)
    return (T.make_level1(ms_pos, radv, fv_vdw, gamma_ms, ish_ms),
            T.make_level1(ms_pos, radv, fv_large, -gamma_ms, ish_ms))


class _MSCavity(torch.autograd.Function):
    """Both MS tree passes over a fixed topology of the replicas' union of
    MS particles (nrep replicas of cap_ms particles): (E of the vdW free
    volumes [nrep], E of the large free volumes [nrep], MS self volumes).

    Backward: the gamma rescans as in _AtomicCavity, each row scaled by
    its own replica's cotangent, for the MS positions, and the cotangents
    of the free volumes through reduce_tree's dv channel (V dE/dV,
    divided by the level-1 volume; a zero-volume padding particle gets
    none).  gamma_ms, ish_ms and the topology get none."""

    @staticmethod
    def forward(ctx, ms_pos, fv_vdw, fv_large, gamma_ms, ish_ms, topo, nrep):
        lvl1_v, lvl1_l = _ms_level1(ms_pos, fv_vdw, fv_large, gamma_ms,
                                    ish_ms)
        levels_v, levels_l = T.rescan_volumes2(topo, lvl1_v, lvl1_l)
        red_l, red_v = T.reduce_tree2(levels_l, levels_v, lvl1_l, lvl1_v,
                                      with_selfvol_b=True, nrep=nrep)
        ctx.rescanned = (levels_v, levels_l, lvl1_v, lvl1_l, gamma_ms)
        return red_v["energy"], red_l["energy"], red_v["self_volume"]

    @staticmethod
    def backward(ctx, g2, g1, w):
        with profiling.span("eval.ms"):
            levels_v, levels_l, lvl1_v, lvl1_l, gamma_ms = ctx.rescanned
            rows = gamma_ms.shape[0] // g2.shape[0]
            gam_v = {**lvl1_v,
                     "gamma1i": g2.repeat_interleave(rows) * gamma_ms + w}
            gam_l = {**lvl1_l,
                     "gamma1i": -g1.repeat_interleave(rows) * gamma_ms}
            red_v = T.reduce_tree(T.rescan_gammas(levels_v, gam_v), gam_v,
                                  with_selfvol=False, with_dv=True)
            red_l = T.reduce_tree(T.rescan_gammas(levels_l, gam_l), gam_l,
                                  with_selfvol=False, with_dv=True)

            def dvol(red, lvl1):
                gv = lvl1["gv"]
                pos_v = gv > 0.0
                return torch.where(pos_v,
                                   red["dv"] / torch.where(pos_v, gv, 1.0),
                                   0.0)

            return (red_v["dr"] + red_l["dr"], dvol(red_v, lvl1_v),
                    dvol(red_l, lvl1_l), None, None, None, None)


class PairCavity(torch.autograd.Function):
    """The GB/vdW pair phases of AGBNP2 with the analytic reverse chain.

    apply(pos, s_factor, phases) -> (gb_self + gb_pair + e_vdw, born_radius,
    gb_self, gb_pair, e_vdw); phases(pos, s_factor) is
    agbnp_torch._pair_phases_kernel (the CUDA kernels #1-#3 on a GPU, their
    twins on the CPU) or plain_pair_phases.  pos [N, 3] and s_factor [N],
    or replicas [B, N, 3] and [B, N] (the kernels' replica axis, one launch
    for the batch; energies [B]).  The phases already give the reverse
    quantities: pair_force = -dE/dpos at fixed volume scaling factors, and
    W + U = dE/d(s_factor).  Only the energy carries a gradient, each
    replica's cotangent scaling its own rows; the other outputs are for
    reporting."""

    @staticmethod
    def forward(ctx, pos, s_factor, phases):
        pp = phases(pos, s_factor)
        ctx.save_for_backward(pp["pair_force"],
                              pp["evdw_der_W"] + pp["egb_der_U"])
        details = (pp["born_radius"], pp["gb_self"].clone(),
                   pp["gb_pair"].clone(), pp["e_vdw"].clone())
        ctx.mark_non_differentiable(*details)
        return (pp["gb_self"] + pp["gb_pair"] + pp["e_vdw"], *details)

    @staticmethod
    def backward(ctx, g_e, *_):
        with profiling.span("eval.pairs"):
            pair_force, wu = ctx.saved_tensors
            return (-g_e[..., None, None] * pair_force, g_e[..., None] * wu,
                    None)


def fixed_topology_diags(topo, caps: T.TreeCaps, caps_ms: T.TreeCaps,
                         natoms: int, cap_ms: int):
    """(diag, ms_diag) of every evaluation on topo, an agbnp2_energy
    topology of nb replicas: both trees' valid rows per replica against
    their capacities and the frozen MS count; zero sibling maxima and
    neighbor and subtraction widths (a rescan builds nothing).  Made once,
    with the topology, so that a fixed-topology evaluation neither counts
    rows nor copies capacity rows from the host (the MD window's step is
    captured as a CUDA graph, md/graphs.py)."""
    count = topo["ms_count"]
    nb, dev = count.shape[0], count.device
    zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
    zeros7 = torch.zeros((nb, 7), dtype=torch.int64, device=dev)
    return (dict(counts=T.replica_counts(topo["atoms"], nb, natoms),
                 max_siblings=zeros7, **T.caps_rows(caps, nb, dev)),
            dict(counts=T.replica_counts(topo["ms"], nb, cap_ms),
                 max_siblings=zeros7, **T.caps_rows(caps_ms, nb, dev),
                 ms_count=count, ms_nbmax=zeros, ms_sub_max=zeros))


def _agbnp2_batch(a: dict, pos, caps: T.TreeCaps, caps_ms: T.TreeCaps,
                  roffset: float, ms_pi, ms_pj, ms_pv, cap_ms: int,
                  ms_kmax: int, common_gamma: float, pair_phases,
                  topology=None, with_topology: bool = False,
                  build_only: bool = False, ms_sub_k: int = 0,
                  ms_sub_rcut: float = 0.0):
    """agbnp2_energy of B replicas pos [B, N, 3] with candidates [B, K]:
    both trees over the replicas' disjoint unions (atom b N + i, MS
    particle b cap_ms + k; ops/tree.py nrep), caps per replica."""
    nb, n = pos.shape[:2]
    dev = pos.device
    au = union_arrays(a, nb, pairs=topology is None)
    pos_u = pos.reshape(-1, 3)
    gamma_dr = au["gamma"] / roffset

    def phase(name):
        # an evaluation's phases; a window's build_only call records as the
        # window build that wraps it
        return contextlib.nullcontext() if build_only else \
            profiling.span(name)

    with phase("eval.tree"):
        if topology is None:
            with torch.no_grad():
                lvl1 = T.make_level1(pos_u.detach(), au["radii_large"],
                                     au["vol_large"], gamma_dr,
                                     au["ishydrogen"])
                levels, diag = T.build_tree(lvl1, au["pairs_i"],
                                            au["pairs_j"], caps,
                                            pairs_valid=au["pairs_valid"],
                                            nrep=nb)
                topo_atoms = T.tree_topology(levels)
        else:
            topo_atoms = topology["atoms"]
            diag = topology["diags"][0]
        lvl1_args = (au["radii_large"], au["vol_large"], au["radii_vdw"],
                     au["vol_vdw"], gamma_dr, au["ishydrogen"])
        e_vol1, e_vol2, sv_large, sv_vdw = _AtomicCavity.apply(
            pos_u, lvl1_args, topo_atoms, nb)

    with phase("eval.ms"):
        # MS particles and free volumes, each replica within its own atoms;
        # with ms_sub_k > 0 the subtraction is bounded to the atoms inside
        # the static horizon, the lists built here at a full build and
        # frozen into the topology for the window
        ms = ms_particles(pos, a["radii_vdw"], ms_pi, ms_pj, ms_pv, cap_ms,
                          idx=None if topology is None
                          else topology["ms_idx"],
                          count=None if topology is None
                          else topology["ms_count"])
        nbr, ms_sub_max = None, None
        if topology is not None:
            nbr = topology["ms_nbr"]
        elif ms_sub_k > 0:
            with torch.no_grad():
                idx_n, nvalid_n, ms_sub_max = ms_atom_neighbors(
                    ms["pos"], ms["valid"], pos, a["ishydrogen"] == 0,
                    ms_sub_rcut, ms_sub_k)
            nbr = (idx_n, nvalid_n)
        fv_large = ms_free_volumes(ms, pos, a["radii_large"],
                                   sv_large.reshape(nb, n), a["ishydrogen"],
                                   nbr=nbr).reshape(-1)
        fv_vdw = ms_free_volumes(ms, pos, a["radii_vdw"],
                                 sv_vdw.reshape(nb, n), a["ishydrogen"],
                                 nbr=nbr).reshape(-1)

        # the MS overlap tree over the union of the replicas' MS particles
        # (padding particles, past each replica's count, have zero volume):
        # built (no gradient) or fixed, then both passes
        gamma_ms = torch.full((nb * cap_ms,), -common_gamma / roffset,
                              dtype=pos.dtype, device=dev)
        ish_ms = 1 - ms["valid"].long().reshape(-1)
        ms_pos = ms["pos"].reshape(-1, 3)
        if topology is None:
            with torch.no_grad():
                lvl1_ms = T.make_level1(ms_pos.detach(), torch.full_like(
                    gamma_ms, SOLVENT_RADIUS), fv_vdw.detach(), gamma_ms,
                    ish_ms)
                mpi, mpj, mpv, m_nbmax = half_neighbor_pairs(
                    ms["pos"].detach(), ms["valid"],
                    tree_pair_cutoff([SOLVENT_RADIUS]), ms_kmax)
                mlevels, mdiag = T.build_tree(lvl1_ms, mpi, mpj, caps_ms,
                                              pairs_valid=mpv, nrep=nb)
                topo_ms = T.tree_topology(mlevels)
            # MS-capacity overflow channels ride the diagnostics for the MD
            # PanicButton: the particle count against cap_ms, the MS-tree
            # neighbor list, the subtraction lists (each [B])
            if ms_sub_max is None:
                ms_sub_max = torch.zeros(nb, dtype=torch.int64, device=dev)
            mdiag = {**mdiag, "ms_count": ms["count"], "ms_nbmax": m_nbmax,
                     "ms_sub_max": ms_sub_max}
            topo = dict(atoms=topo_atoms, ms=topo_ms, ms_idx=ms["idx"],
                        ms_count=ms["count"], ms_nbr=nbr)
            if with_topology or build_only:
                topo["diags"] = fixed_topology_diags(topo, caps, caps_ms, n,
                                                     cap_ms)
        else:
            topo = topology
            topo_ms = topology["ms"]
            mdiag = topology["diags"][1]
        if build_only:
            return (diag, mdiag), topo
        e_ms_vdw, e_ms_large, sv_ms = _MSCavity.apply(
            ms_pos, fv_vdw, fv_large, gamma_ms, ish_ms.to(pos.dtype),
            topo_ms, nb)

        # MS self volumes go half to each parent atom of the union (sorted
        # segment sums: deterministic)
        off = n * torch.arange(nb, device=dev)[:, None]
        svadd = (0.5 * T.segment_sum(sv_ms[:, None],
                                     (ms["p1"] + off).reshape(-1),
                                     nb * n)[:, 0]
                 + 0.5 * T.segment_sum(sv_ms[:, None],
                                       (ms["p2"] + off).reshape(-1),
                                       nb * n)[:, 0])
        self_volume = (sv_vdw + svadd).reshape(nb, n)
    s_factor = self_volume / a["vol_vdw_all"]
    with phase("eval.pairs"):
        e_pair, br, gb_self, gb_pair, e_vdw = PairCavity.apply(
            pos, s_factor, functools.partial(pair_phases, a))

    energy = e_vol1 + e_vol2 + e_ms_vdw + e_pair + e_ms_large
    details = dict(e_vol1=e_vol1, e_vol2=e_vol2, e_ms_vdw=e_ms_vdw,
                   e_ms_large=e_ms_large, gb_self=gb_self, gb_pair=gb_pair,
                   e_vdw=e_vdw, num_ms=ms["count"], self_volume=self_volume,
                   born_radius=br)
    if with_topology:
        return energy, (diag, mdiag), details, topo
    return energy, (diag, mdiag), details


def agbnp2_energy(a: dict, pos, caps: T.TreeCaps, caps_ms: T.TreeCaps,
                  roffset: float, ms_pi, ms_pj, ms_pv, cap_ms: int,
                  ms_kmax: int, common_gamma: float, pair_phases,
                  topology=None, with_topology: bool = False,
                  build_only: bool = False, ms_sub_k: int = 0,
                  ms_sub_rcut: float = 0.0):
    """Total AGBNP2 energy as a function of pos (autograd gives forces).

    a: arrays_from_numpy dict; pair_phases(a, pos, s_factor) -> the pair
    phases' dict (pair_phases_fn's).  pos [N, 3] with MS candidate pairs
    ms_pi/ms_pj/ms_pv [K] is one system; replicas pos [B, N, 3] take [B, K]
    candidates in each replica's own atom ids and evaluate as one batch
    (both overlap trees over the replicas' unions, the pair kernels'
    replica axis): the energy [B] and every leaf of the diagnostics and
    details with a leading [B].  One system is a batch of one, the axis
    dropped.  topology (from an earlier with_topology=True call at nearby
    positions, of as many replicas) replaces both tree builds with
    fixed-topology rescans and reuses the frozen MS compaction and
    subtraction lists: the stale-topology MD window (volumes exact at the
    current positions, node sets from the build).  The candidates must
    then be the ones the topology was built from, and the diagnostics are
    the ones the topology carries (fixed_topology_diags).

    Returns (energy, (diag, ms_diag), details), plus the topology with
    with_topology=True.  build_only=True returns ((diag, ms_diag),
    topology) as soon as both topologies are built (no MS passes, no pair
    phases): the window start of the MD loop."""
    kw = dict(caps=caps, caps_ms=caps_ms, roffset=roffset, cap_ms=cap_ms,
              ms_kmax=ms_kmax, common_gamma=common_gamma,
              pair_phases=pair_phases, topology=topology,
              with_topology=with_topology, build_only=build_only,
              ms_sub_k=ms_sub_k, ms_sub_rcut=ms_sub_rcut)
    if pos.dim() == 3:
        return _agbnp2_batch(a, pos, ms_pi=ms_pi, ms_pj=ms_pj, ms_pv=ms_pv,
                             **kw)
    out = _agbnp2_batch(a, pos[None], ms_pi=ms_pi[None], ms_pj=ms_pj[None],
                        ms_pv=ms_pv[None], **kw)

    def row0(d):
        return {k: v[0] for k, v in d.items()}

    if build_only:
        (diag, mdiag), topo = out
        return (row0(diag), row0(mdiag)), topo
    energy, (diag, mdiag), details = out[:3]
    return (energy[0], (row0(diag), row0(mdiag)), row0(details)) + out[3:]


def plain_pair_phases(a, pos, s_factor, cutoff, ntypes_j: int):
    """The plain ops/born.py phases (no box, the 2 nm horizon) of pos
    [N, 3], or of each replica of pos [B, N, 3] in turn (the plain phases
    have no replica axis)."""
    kw = dict(a=a, cutoff=cutoff, box=None, ntypes_j=ntypes_j)
    if pos.dim() == 2:
        return _pair_phases_plain(pos=pos, s_factor=s_factor, **kw)
    return PK.per_replica(_pair_phases_plain, pos.shape[0],
                          dict(pos=pos, s_factor=s_factor), **kw)


def pair_phases_fn(pair_kernel: bool, cutoff, pair_pad: int, ntypes_j: int):
    """pair_phases(a, pos, s_factor) for agbnp2_energy: the dense kernel
    route (pair_pad > 0, no box, no fused MM, the 2 nm horizon, as JAX's
    v2 runs its Pallas phases; replicas through the kernels' replica axis)
    or the plain ops/born.py phases."""
    if pair_kernel:
        return functools.partial(_pair_phases_kernel, cutoff=cutoff,
                                 box=None, pair_pad=pair_pad)
    return functools.partial(plain_pair_phases, cutoff=cutoff,
                             ntypes_j=ntypes_j)


def ms_candidate_pairs(pos, heavy, rcut: float, kmax: int):
    """MS candidate pairs found on the device (JAX's scorer and per-step
    force, api/scoring.py:150-152): the heavy pairs i < j within rcut as a
    padded half list of width kmax (i-major, ascending j: the order of
    ms_candidates' host pairs).  pos [N, 3] gives flat [N kmax] pairs;
    replicas pos [B, N, 3] give [B, N kmax] in each replica's own atom
    ids.  Returns (pi, pj, pvalid, the most candidates of one atom: [B]
    for replicas; > kmax means truncation)."""
    pi, pj, pv, nbmax = half_neighbor_pairs(pos, heavy, rcut, kmax)
    if pos.dim() == 3:
        nb, n = pos.shape[:2]
        off = n * torch.arange(nb, device=pos.device)[:, None]
        pi = pi.reshape(nb, -1) - off
        pj = pj.reshape(nb, -1) - off
        pv = pv.reshape(nb, -1)
    return pi, pj, pv, nbmax


def ms_candidates(pos, params: AGBNPParams):
    """The heavy pairs i < j within ms_pair_cutoff at pos (host numpy):
    (pi, pj) int64."""
    pos = np.asarray(pos)
    heavy = np.asarray(params.ishydrogen) == 0
    rc = ms_pair_cutoff(params.radii_vdw)
    d = np.linalg.norm(pos[None] - pos[:, None], axis=-1)
    jj = np.arange(params.n)
    ok = ((jj[None, :] > jj[:, None]) & (d < rc)
          & heavy[:, None] & heavy[None, :])
    return np.nonzero(ok)


def ms_sub_width(pos, params: AGBNPParams, pi, pj, rcut: float,
                 cap_ms: int) -> int:
    """The JAX package's width of the neighbor-bounded MS subtraction: 0
    (the dense form) while cap_ms x N <= 2^26, else the most heavy atoms
    within rcut of a candidate's MS position x 1.5, 16-aligned."""
    heavy = np.asarray(params.ishydrogen) == 0
    if not len(pi):
        return 16
    if cap_ms * params.n <= (1 << 26):
        return 0
    pos = np.asarray(pos)
    r1 = params.radii_vdw[pi]
    r2 = params.radii_vdw[pj]
    dd = np.linalg.norm(pos[pj] - pos[pi], axis=-1) + 1e-30
    fms = 0.5 * (1.0 + (r1 - r2) / dd)
    mpos = pos[pj] * fms[:, None] + pos[pi] * (1.0 - fms)[:, None]
    ph = pos[heavy]
    seen = 0
    for s in range(0, len(mpos), 2048):
        dm = np.linalg.norm(mpos[s:s + 2048, None, :] - ph[None, :, :],
                            axis=-1)
        seen = max(seen, int((dm < rcut).sum(axis=1).max()))
    return min(capacity.kmax_for(seen), int(heavy.sum()))


class AGBNP2Model:
    """Prepared AGBNP2 system: energy and autograd forces.

    device: where the arrays live and the evaluation runs (no default).
    positions are required: they size the tree capacities (the atomic tree
    by one build on the device, AGBNPModel.size_caps; the MS capacities by
    the JAX package's rules) and pick the MS candidate pairs, which stay
    fixed until set_positions picks them anew; without cap_ms, cap_ms is
    ms_boost x those candidates, 128-aligned.  An evaluation does not
    check its capacities: check_and_grow does, on its diagnostics (the
    Context's PanicButton loop).  pair_kernel: None takes the CUDA
    pair kernels on a CUDA device at float32 and the plain phases
    otherwise; True on the CPU runs the kernels' twins; False the plain
    ops/born.py phases.  The kernels take float32 only: pair_kernel=True on
    a CUDA device at float64 raises at the first evaluation.
    """

    def __init__(self, params_in, *, device, dtype=torch.float64,
                 positions=None, cutoff: float | None = None,
                 ms_boost: float = 1.6, caps: T.TreeCaps | None = None,
                 caps_ms: T.TreeCaps | None = None, cap_ms: int | None = None,
                 ms_kmax: int | None = None, ms_sub_k: int | None = None,
                 pair_kernel: bool | None = None):
        if positions is None:
            raise ValueError("AGBNP2Model needs initial positions for sizing")
        params = AGBNPParams(radius=params_in.radius, gamma=params_in.gamma,
                             alpha=params_in.alpha, charge=params_in.charge,
                             ishydrogen=params_in.ishydrogen,
                             roffset=AGBNP2_RADIUS_INCREMENT)
        self.params = params
        self.version = 2
        self.device = torch.device(device)
        self.dtype = dtype
        self.cutoff = cutoff
        if pair_kernel is None:
            pair_kernel = (self.device.type == "cuda"
                           and dtype == torch.float32)
        self.pair_kernel = bool(pair_kernel)
        self.pair_pad = (PK.pad_to(params.n, PK.pick_tile(params.n))
                         if self.pair_kernel else 0)
        pos = np.asarray(positions, dtype=np.float64)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.arrays_np = prepare_arrays(params, dtype=np_dtype,
                                        pair_pad=self.pair_pad,
                                        positions=pos)
        self.arrays = arrays_from_numpy(self.arrays_np, self.device, dtype)
        self.ntypes_j = int(np.max(self.arrays_np["type_j"]) + 1)
        heavy = np.asarray(params.ishydrogen) == 0
        g = np.asarray(params.gamma)[heavy]
        self.common_gamma = float(g[0]) if len(g) else 0.0
        # the atomic tree: AGBNPModel's device sizing at these radii
        self.caps = caps if caps is not None else AGBNPModel(
            params, device=self.device, dtype=dtype, version=0,
            positions=pos).caps

        pi, pj = self.set_positions(pos)
        self.cap_ms = (cap_ms if cap_ms is not None else
                       capacity.grow_past(len(pi), ms_boost, 128, 128))
        self.ms_kmax = ms_kmax if ms_kmax is not None else 64
        self.caps_ms = (caps_ms if caps_ms is not None else
                        T.TreeCaps.for_natoms(max(self.cap_ms // 8, 64)))
        self.ms_sub_rcut = ms_subtraction_horizon(params.radii_vdw,
                                                  params.radii_large)
        self.ms_sub_k = int(ms_sub_k if ms_sub_k is not None else
                            ms_sub_width(pos, params, pi, pj,
                                         self.ms_sub_rcut, self.cap_ms))
        self.pair_phases = pair_phases_fn(self.pair_kernel, cutoff,
                                          self.pair_pad, self.ntypes_j)

    def set_positions(self, positions):
        """Pick the MS candidate pairs anew at positions: the heavy pairs
        within ms_pair_cutoff (host numpy), which a later evaluation reads.
        The capacities stay.  Returns the pairs (pi, pj)."""
        pi, pj = ms_candidates(np.asarray(positions, np.float64), self.params)
        self.ms_pi = torch.as_tensor(pi, dtype=torch.int64,
                                     device=self.device)
        self.ms_pj = torch.as_tensor(pj, dtype=torch.int64,
                                     device=self.device)
        self.ms_pv = torch.ones(len(pi), dtype=torch.bool, device=self.device)
        return pi, pj

    def check_and_grow(self, diags) -> bool:
        """PanicButton over one evaluation's diagnostics (agbnp2_energy's
        (diag, ms_diag), from tree builds; a batch's are reduced to its
        worst replica): double each overflowed level or sibling window of
        either tree (capacity.grow_tree), and widen cap_ms, the MS tree's
        neighbor width and the MS subtraction width past the counts that
        overflowed them.  Returns True if a re-evaluation is needed."""
        d0, d1 = diags
        if torch.as_tensor(d0["counts"]).dim() == 2:
            d0, d1 = batched_diag_max(d0), batched_diag_max(d1)
        count, nbmax, sub_max = (int(d1[k]) for k in
                                 ("ms_count", "ms_nbmax", "ms_sub_max"))
        old = (self.caps, self.caps_ms, self.cap_ms, self.ms_kmax,
               self.ms_sub_k)
        self.caps = capacity.grow_tree(self.caps, d0)
        self.caps_ms = capacity.grow_tree(self.caps_ms, d1)
        self.cap_ms = capacity.widened(self.cap_ms, count, 128)
        self.ms_kmax = capacity.widened(self.ms_kmax, nbmax)
        if self.ms_sub_k:  # the subtraction lists exist only then
            self.ms_sub_k = capacity.widened(self.ms_sub_k, sub_max)
        return old != (self.caps, self.caps_ms, self.cap_ms, self.ms_kmax,
                       self.ms_sub_k)

    def energy_kwargs(self) -> dict:
        """agbnp2_energy's static arguments for this model."""
        return dict(caps=self.caps, caps_ms=self.caps_ms,
                    roffset=self.params.roffset, cap_ms=self.cap_ms,
                    ms_kmax=self.ms_kmax, common_gamma=self.common_gamma,
                    pair_phases=self.pair_phases, ms_sub_k=self.ms_sub_k,
                    ms_sub_rcut=self.ms_sub_rcut)

    def batched_energy_forces(self, pos, ms_pairs=None) -> dict:
        """Energy and autograd forces of B conformations pos [B, N, 3] in
        one batched evaluation (JAX's vmapped agbnp2_energy): dict(energy
        [B], force [B, N, 3], diags ((diag, ms_diag), every leaf [B, ...]),
        details (each [B, ...])).  ms_pairs: each replica's MS candidate
        pairs (pi, pj, pvalid) [B, K] (ms_candidate_pairs builds them on
        the device); None gives every replica the model's own
        (set_positions')."""
        x = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        if x.dim() != 3:
            raise ValueError(f"positions [B, N, 3], got {tuple(x.shape)}")
        if ms_pairs is None:
            ms_pairs = tuple(t[None].expand(x.shape[0], -1) for t in
                             (self.ms_pi, self.ms_pj, self.ms_pv))
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            e, diags, details = agbnp2_energy(
                self.arrays, x, ms_pi=ms_pairs[0], ms_pj=ms_pairs[1],
                ms_pv=ms_pairs[2], **self.energy_kwargs())
            (grad,) = torch.autograd.grad(e.sum(), x)
        return dict(energy=e.detach(), force=-grad, diags=diags,
                    details={k: v.detach() for k, v in details.items()})

    def energy_forces(self, pos, with_details: bool = False):
        """(energy, force[, out]) of one system pos [N, 3], on the model's
        own MS candidates: row 0 of batched_energy_forces of a batch of
        one.  force = -d(energy)/d(pos) by autograd; out = dict(energy,
        force, diags, details), the replica axis dropped."""
        x = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        out = self.batched_energy_forces(x[None])
        energy, force = out["energy"][0], out["force"][0]
        if with_details:
            return energy, force, dict(
                energy=energy, force=force,
                diags=tuple({k: v[0] for k, v in d.items()}
                            for d in out["diags"]),
                details={k: v[0] for k, v in out["details"].items()})
        return energy, force
