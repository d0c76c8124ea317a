"""MD of a DMS system with AGBNP implicit solvent + OPLS.

Counterpart of the JAX package's md/simulation.py.  AGBNP version 1 runs
the pair sweeps on the kernel route (over interacting-tile lists by
default, as in JAX) with the MM dense LJ + Coulomb sum fused into the GB
sweep, and every MD configuration of the JAX package's benchmark
(bench.py):

  * rebuild windows: a half neighbor list (through a cell grid above 3000
    atoms) and an overlap-tree topology every `neighbor_every` steps,
    fixed-topology rescans in between (`rebuild_topology=False`: a tree
    build every step from the window's list; `neighbor_every <= 0`: the
    all-pairs evaluation every step);
  * the vdW-compact WU topology (`vdw_compact=True`, the default): the WU
    gamma-rescan force pass runs over the ancestor closure of the vdW-live
    tree rows, extracted at each rebuild (ops/tree.py::compact_topology);
  * the WU pass as an r-RESPA impulse every `wu_every` steps (mts_wu);
  * r-RESPA MTS (`mts_inner`: AGBNP + MM nonbonded as the slow impulse,
    bonded + 1-4 substeps), SHAKE/RATTLE X-H constraints, virtual sites;
  * velocity Verlet, FIRE (md/minimize.py), and `run_md` with the
    PanicButton retry, trajectory frames and exact-resume checkpoints.

The JAX runner's `lax.scan` over the steps of a window is a Python loop
here.  Per-step overflow counts (tree levels, tile lists, WU-compact rows)
and the SHAKE residual stay on the device, and the host reads them once
per window; a window that overflowed (or whose SHAKE missed tolerance)
stops the run, and its counts come back for the PanicButton regrow.

Version 0 (GVolSA) takes the same runner paths without pair phases, the
MM force field by autograd.  Version 2 (AGBNP2, models/agbnp2_torch.py:
energy by PyTorch, forces by autograd through its analytic reverse rules,
the dense pair kernels #1-#3 on a card at float32) runs rebuild windows as
the JAX package does: one build a window (both tree topologies and the
frozen MS compaction, _v2_build), fixed-topology steps in between, an
18-entry overflow vector read once a window; no MTS, no WU impulse, no
vdW-compact WU pass.  Its force function also takes replicas [R, N, 3]
(one batched AGBNP2 evaluation: the per-step replica path of
parallel/ensemble.py).

Options as the JAX package's: include_mm=False drops the OPLS force field
(the AGBNP part alone; no MTS then), pair_kernel=False takes the dense
ops/born.py pair phases (any dtype on any device; the kernels take
float32 only), pairs gives the tree's candidate pairs, and
make_langevin_runner(topology_relax=) keeps birth-margin rows in each
window's tree (ops/tree.py::build_tree, relax).

Mesh sharding (JAX md/simulation.py:237-310, 466-551): force_fn(mesh=)
and make_langevin_runner(mesh=) take an `atoms` mesh
(parallel/sharding.py::atom_mesh, one rank a process) and run each step's
fixed-topology tree passes and pair phases in row blocks over it
(sharded_energy_forces); the tree build at each rebuild boundary, the MM
terms (by autograd, not fused into a sweep) and the integrator stay
replicated, the same bits on every rank.  Version 1 with rebuild windows
only; no MTS, no WU impulse and no vdW-compact WU pass under a mesh.

Not ported here: `mixed=True`.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..io.checkpoint import save_checkpoint
from ..models.agbnp2_torch import AGBNP2Model, agbnp2_energy, \
    ms_candidate_pairs, ms_pair_cutoff, v2_counts
from ..models.agbnp_torch import AGBNPModel, energy_forces, union_arrays
from ..models.params import AGBNPParams
from ..ops import tree as T
from ..ops.neighbors import CellGrid, cell_neighbor_pairs, \
    half_neighbor_pairs, host_max_neighbors, tree_pair_cutoff
from .constraints import Constraints
from .forces import MMForceField
from .integrators import langevin_middle_step, maxwell_boltzmann_velocities, \
    mts_langevin_step, running_max, velocity_verlet_step, \
    wu_impulse_langevin_block
from .vsites import project_positions, spread_forces


def _kmax_for(seen: int) -> int:
    return int(np.ceil(seen * 1.5 / 16) * 16)


def _align(x, align: int = 128) -> int:
    return max(align, int(np.ceil(x / align)) * align)


class Simulation:
    """MD simulation of a DMS system with AGBNP implicit solvent (the
    reference benchmark scripts' DesmondDMSFile.createSystem(
    implicitSolvent='AGBNP') + LangevinIntegrator + Simulation.step).

    device: where every array lives and every step runs (no default);
    dtype: float64 for CPU parity work, float32 on the GPU (the CUDA pair
    kernels take float32 only; pair_kernel=False runs the dense
    ops/born.py pair phases instead, in any dtype).  pair_tiles, share_qd,
    pair_kernel and pairs go to AGBNPModel (interacting-tile-list budgets,
    None = sized from the initial positions; Q/dQ sharing between the Born
    and descreening sweeps; None = the kernel route; the tree's candidate
    pairs (i, j[, valid]), None = the model's own).  include_mm=False
    leaves the OPLS force field out: the forces are the AGBNP part alone
    (and MTS, which needs the bonded class, raises).
    constraints=True applies the DMS X-H constraint tables
    (md/constraints.py) in every integrator; vsites: a VirtualSites table
    (md/vsites.py) projected before and spread after every evaluation.
    Without `caps`, the tree capacities are sized from the DMS positions
    with caps_boost headroom (AGBNPModel.size_caps): MD runs leaner than
    the one-shot model's 1.6, since every row-indexed tree op costs per
    padded row, counts drift slowly at equilibrium, and the PanicButton
    covers the tail.

    version: 0 (GVolSA), 1 (AGBNP1) or 2 (AGBNP2, an AGBNP2Model sized
    from the DMS positions as JAX sizes it; its pair phases run through the
    CUDA kernels on a card at float32).
    """

    def __init__(self, dms, *, device, version: int = 1,
                 cutoff: float | None = None, dtype=torch.float64,
                 caps=None, skin: float = 0.15, kmax: int | None = None,
                 caps_boost: float = 1.10, descreen_horizon=None,
                 pair_tiles=None, share_qd: bool = True,
                 constraints: bool = False, vsites=None,
                 include_mm: bool = True, pairs=None, pair_kernel=None):
        if version not in (0, 1, 2):
            raise ValueError(f"version {version}: expected 0, 1 or 2")
        self.dms = dms
        self.device = torch.device(device)
        self.dtype = dtype
        params = AGBNPParams(radius=dms.agbnp_radius, gamma=dms.agbnp_gamma,
                             alpha=dms.agbnp_alpha, charge=dms.charges,
                             ishydrogen=dms.ishydrogen)
        self.agbnp2 = None
        if version == 2:
            # AGBNP2: MS candidate pairs rebuilt on the device at every
            # window start from a half list within ms_pair_cutoff
            self.agbnp2 = AGBNP2Model(params, device=self.device, dtype=dtype,
                                      positions=np.asarray(dms.positions),
                                      cutoff=cutoff, caps=caps,
                                      pair_kernel=pair_kernel)
            self.agbnp = self.agbnp2
            self.ms_rcut = ms_pair_cutoff(params.radii_vdw)
            self.ms_kmax_list = _kmax_for(host_max_neighbors(
                np.asarray(dms.positions), np.asarray(params.ishydrogen) == 0,
                self.ms_rcut))
        else:
            self.agbnp = AGBNPModel(params, device=self.device, dtype=dtype,
                                    version=version, cutoff=cutoff,
                                    caps=caps, positions=dms.positions,
                                    caps_boost=caps_boost,
                                    descreen_horizon=descreen_horizon,
                                    pair_tiles=pair_tiles, share_qd=share_qd,
                                    pair_kernel=(pair_kernel is None
                                                 or bool(pair_kernel)),
                                    pairs=pairs)
        self.pairs = pairs
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.mm = (MMForceField.from_dms(dms, cutoff=cutoff, dtype=np_dtype)
                   if include_mm else None)
        self.masses = torch.as_tensor(dms.masses, dtype=dtype,
                                      device=self.device)
        self.positions = torch.as_tensor(dms.positions, dtype=dtype,
                                         device=self.device)
        self.velocities = torch.as_tensor(dms.velocities, dtype=dtype,
                                          device=self.device)
        self.vsites = (vsites.arrays(dtype, device=self.device)
                       if vsites is not None and vsites.count > 0 else None)
        # Desmond X-H constraint tables -> SHAKE/RATTLE in the MD loop (the
        # reference gets these through DesmondDMSFile.createSystem)
        self.constraints = (Constraints.from_dms(dms, device=self.device)
                            if constraints else None)
        # per-level WU-compact capacities (relax, caps), sized lazily
        self._vdw_caps = None

        # neighbor-list sizing pass (the analogue of the reference's CPU
        # GaussVol pre-pass, OpenCLAGBNPKernels.cpp:566-617)
        self.rcut_list = tree_pair_cutoff(params.radii_large) + skin
        heavy = np.asarray(params.ishydrogen) == 0
        if kmax is None:
            kmax = _kmax_for(host_max_neighbors(np.asarray(dms.positions),
                                                heavy, self.rcut_list))
        self.kmax = kmax
        self.heavy_mask = torch.as_tensor(heavy, device=self.device)
        self._set_grid(np.asarray(dms.positions))

    def _set_grid(self, positions, grid=None):
        """The neighbor build: an O(N) cell grid above the dense-rebuild
        crossover (the analogue of OpenMM's cell-based tiles the reference
        rides), the all-pairs half list below it."""
        if grid is None and self.agbnp.params.n > 3000:
            grid = CellGrid(positions, self.rcut_list,
                            heavy_mask=np.asarray(self.heavy_mask.cpu()))
        self.grid = grid
        self.neighbor_fn = (functools.partial(cell_neighbor_pairs, grid=grid)
                            if grid is not None else half_neighbor_pairs)

    def resize_caps_to_current(self, positions=None, caps_boost: float = 1.3):
        """Shrink-to-fit: re-size every capacity (tree caps and sibling
        windows, neighbor kmax, cell grid, WU-compact caps, tile budgets)
        from a fresh sizing pass on the CURRENT configuration, discarding
        the regrow history (JAX md/simulation.py:126-160).

        The tree sizing is AGBNPModel.size_caps (one tree build on the
        device, the native pre-pass's headroom rules: sibling windows at
        least 4, so a window can never come out degenerate).  Runners built
        before this call are stale; if the lean capacities prove too small
        the PanicButton grows them back."""
        if self.agbnp2 is not None:
            raise ValueError("resize_caps_to_current supports versions 0/1")
        pos = (self.positions if positions is None else torch.as_tensor(
            positions, dtype=self.dtype, device=self.device))
        pos_np = pos.detach().cpu().numpy()
        m = self.agbnp
        self.agbnp = AGBNPModel(m.params, device=self.device,
                                dtype=self.dtype, version=m.version,
                                cutoff=m.cutoff, positions=pos_np,
                                caps_boost=caps_boost,
                                descreen_horizon=m.descreen_horizon,
                                pair_tiles=(None if m.pair_tiles is not None
                                            else False),
                                share_qd=m.share_qd,
                                pair_kernel=m.pair_kernel, pairs=self.pairs)
        self.kmax = _kmax_for(host_max_neighbors(
            pos_np, np.asarray(self.heavy_mask.cpu()), self.rcut_list))
        if self.grid is not None:
            self._set_grid(pos_np)
        # the lazy WU-compact sizing pass reads self.positions; point it at
        # the configuration being sized from
        self.positions = pos
        self._vdw_caps = None

    def set_velocities_to_temperature(self, temperature, seed: int = 0):
        """Maxwell-Boltzmann velocities at `temperature` (OpenMM's
        Context.setVelocitiesToTemperature analogue), COM motion removed,
        drawn from a generator on the simulation's device seeded with
        `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.velocities = maxwell_boltzmann_velocities(self.masses,
                                                       temperature, gen)
        return self.velocities

    def _fuse_mm(self) -> bool:
        """The MM LJ + Coulomb sum rides the GB sweep: AGBNP1 on the kernel
        route.  Versions 0 and 2 and the plain route add the dense sum by
        autograd."""
        return (self.mm is not None and self.agbnp.version == 1
                and self.agbnp.pair_pad > 0)

    def ff_state(self, fuse_mm: bool | None = None) -> dict:
        """Force-field tensors the MD step reads: the AGBNP arrays, the MM
        arrays, and the exclusions: as rows in the pair sweeps'
        Morton-permuted row space (rows reordered, atom-id values remapped)
        where the GB sweep carries the MM sum, else as an [N, N] mask.
        Without the MM force field (include_mm=False), the AGBNP arrays
        alone.  fuse_mm=False keeps the MM sum out of the sweeps (the mesh
        path); None fuses it wherever the kernel route can carry it."""
        ff = dict(a=self.agbnp.arrays)
        if self.mm is None:
            return ff
        ff["mm"] = self.mm.tensors(self.device, self.dtype)
        if fuse_mm is None:
            fuse_mm = self._fuse_mm()
        if not fuse_mm:
            ff["mm_excl_mask"] = torch.as_tensor(self.mm.excl_mask(),
                                                 device=self.device)
            return ff
        a = self.agbnp.arrays_np
        er = self.mm.excl_rows()
        rinv = a["rinv"]
        epm = np.where(er >= 0, rinv[np.clip(er, 0, None)], -1)
        ff["excl_rows_perm"] = torch.as_tensor(
            epm[a["rperm"]].astype(np.int32), device=self.device)
        return ff

    def _sharded_ef(self, mesh):
        """The sharded_energy_forces closure for this mesh, cached (the
        fixed-topology AGBNP1 evaluation over the `atoms` mesh)."""
        if getattr(self, "_sharded_fn_mesh", None) is not mesh:
            from ..parallel.sharding import sharded_energy_forces

            m = self.agbnp
            self._sharded_fn = sharded_energy_forces(
                mesh, m.arrays, m.params.roffset, m.ntypes_j,
                cutoff=m.cutoff, box=m.box,
                descreen_horizon=m.descreen_horizon)
            self._sharded_fn_mesh = mesh
        return self._sharded_fn

    def _check_mesh(self, mesh, topology_ok: bool = True):
        if mesh is None:
            return
        if self.agbnp2 is not None or self.agbnp.version != 1:
            raise ValueError("mesh-sharded force requires version 1")
        if not topology_ok:
            raise ValueError("mesh-sharded force requires version 1 and a "
                             "prebuilt topology")

    def force_fn(self, pairs=None, topology=None, ff=None,
                 split: bool = False, vdw_topology=None,
                 wu_mode: str = "fused", mesh=None):
        """Returns fn(pos) -> (energy, force, counts).

        AGBNP1 energy + analytic forces with the OPLS dense LJ + Coulomb
        sum riding the GB sweep; bonded terms and 1-4 pairs by autograd
        (version 0: the whole MM force field by autograd; version 2: see
        _force_fn_v2, where pairs are the MS candidate pairs and topology
        the window's _v2_build).
        pairs: (pairs_i, pairs_j, pairs_valid) from the neighbor list (the
        tree's 2-body candidates; None: the model's all-pairs list);
        topology: a tree_topology() of an earlier build (fixed-topology
        rescans); vdw_topology: the window's compacted WU topology.  counts:
        the tree-level counts, followed by the in-range Born and GB tile
        counts when the sweeps run on interacting-tile lists.

        wu_mode "split" makes fn return (energy, force_without_wu,
        force_wu, counts) and "skip" leaves the WU pass out (the WU impulse
        block's two evaluations).  With split=True, returns (slow_fn,
        fast_fn) for the r-RESPA integrators instead: slow_fn(pos) ->
        (e, f, counts) is AGBNP + the fused MM nonbonded sum, fast_fn(pos)
        -> (e, f) the stiff bonded + 1-4 class.

        With mesh (an `atoms` mesh, parallel/sharding.py::atom_mesh), the
        AGBNP1 tree passes and pair phases of the fixed topology run in
        row blocks over the mesh (sharded_energy_forces): version 1 with a
        topology, no MTS, no WU split or skip, no compacted WU topology,
        the MM terms by autograd (ff from ff_state(fuse_mm=False))."""
        self._check_mesh(mesh, topology is not None)
        if mesh is not None and (split or wu_mode != "fused"
                                 or vdw_topology is not None):
            raise ValueError("mesh-sharded force: no MTS split, no WU "
                             "split/skip and no compacted WU topology")
        if self.agbnp2 is not None:
            if split:
                raise ValueError("MTS supports AGBNP versions 0/1")
            if wu_mode != "fused":
                raise ValueError("wu_mode split/skip (mts_wu) requires "
                                 "version 1")
            return self._force_fn_v2(ms_pairs=pairs, topology=topology,
                                     ff=ff)
        if split and self.mm is None:
            raise ValueError("MTS needs an MM force field (the fast class)")
        if wu_mode != "fused" and split:
            raise ValueError("wu_mode split/skip (mts_wu) does not combine "
                             "with MTS")
        if wu_mode != "fused" and self.agbnp.version != 1:
            raise ValueError("wu_mode split/skip (mts_wu) requires version 1")
        if ff is None:
            ff = self.ff_state(fuse_mm=False if mesh is not None else None)
        m = self.agbnp
        if pairs is None and m.neighbor_kmax > 0:
            raise ValueError("the all-pairs evaluation (no neighbor list) "
                             "holds for systems up to 2000 atoms")
        a = ff["a"]
        if pairs is not None:
            a = {**a, "pairs_i": pairs[0], "pairs_j": pairs[1],
                 "pairs_valid": pairs[2]}
        mm = ff.get("mm")
        fuse_mm = "excl_rows_perm" in ff
        if fuse_mm and mesh is not None:
            raise ValueError("mesh-sharded force: take ff_state(fuse_mm="
                             "False)")
        mm_nb = (dict(sigma=mm["sigma"], epsq=mm["epsq"],
                      excl_rows_perm=ff["excl_rows_perm"])
                 if fuse_mm else None)
        vs = self.vsites
        if mesh is not None:
            sfn = self._sharded_ef(mesh)
            # the fixed topology's level counts (a rescan cannot overflow)
            mesh_counts = T.replica_counts(topology, 1, m.params.n)[0]

            def sharded_part(pos):
                out = sfn(pos, topology, arrays=a)
                return out["energy"], out["force"], None, mesh_counts

        def agbnp_part(pos):
            # the WU force comes back apart and is added last, so the fused
            # force is bit for bit what the WU impulse block adds up at k=1
            out = energy_forces(a, pos, caps=m.caps, version=m.version,
                                roffset=m.params.roffset,
                                ntypes_j=m.ntypes_j, cutoff=m.cutoff,
                                topology=topology, box=m.box,
                                pair_pad=m.pair_pad,
                                pair_rows=pairs is not None, mm_nb=mm_nb,
                                descreen_horizon=m.descreen_horizon,
                                pair_tiles=m.pair_tiles,
                                share_qd=m.share_qd,
                                vdw_topology=vdw_topology,
                                wu_mode="skip" if wu_mode == "skip"
                                else "split")
            energy = out["energy"]
            if fuse_mm:
                energy = energy + out["details"]["e_mm_nb"]
            counts = out["diag"]["counts"].long()
            ptc = out["diag"].get("pair_tile_counts")
            if ptc is not None:
                # the tile-list counts ride the tree counts' overflow
                # channel (split off again in overflow_report)
                counts = torch.cat([counts, ptc.long()], dim=-1)
            return energy, out["force"], out["details"].get("force_wu"), \
                counts

        def spread(f):
            return f if vs is None else spread_forces(f, vs)

        def project(pos):
            return pos if vs is None else project_positions(pos, vs)

        def mm_forces(pos):
            # the MM terms the pair sweeps do not carry
            if fuse_mm:
                return self.mm.bonded_and_14_forces(pos, mm)
            return self.mm.forces_of(self.mm.energy, pos, mm,
                                     ff["mm_excl_mask"])

        if split:
            def slow_fn(pos):
                pos = project(pos)
                energy, force, f_wu, counts = agbnp_part(pos)
                if f_wu is not None:
                    force = force + f_wu
                if not fuse_mm:
                    # the dense LJ/Coulomb sum belongs to the slow class
                    e_nb, f_nb = self.mm.forces_of(
                        self.mm.energy_nonbonded, pos, mm,
                        ff["mm_excl_mask"])
                    energy = energy + e_nb
                    force = force + f_nb
                return energy, spread(force), counts

            def fast_fn(pos):
                e, f = self.mm.bonded_and_14_forces(project(pos), mm)
                return e, spread(f)

            return slow_fn, fast_fn

        part = agbnp_part if mesh is None else sharded_part

        def fn(pos):
            pos = project(pos)
            energy, force, f_wu, counts = part(pos)
            if mm is not None:
                e_mm, f_mm = mm_forces(pos)
                energy = energy + e_mm
                force = force + f_mm
            force = spread(force)
            if wu_mode == "split":
                return energy, force, spread(f_wu), counts
            if wu_mode == "fused" and f_wu is not None:
                force = force + spread(f_wu)
            return energy, force, counts

        return fn

    def _v2_build(self, pos, ff=None):
        """Window-start AGBNP2 build: both tree topologies and the frozen MS
        compaction at pos ([N, 3], or [R, N, 3] for replicas), from MS
        candidate pairs found on the device.  Returns (ms_pairs,
        (topology, counts)) in force_fn's convention (pairs=, topology=),
        counts the 18-entry vector (v2_counts; [R, 18] for replicas)."""
        a = self.agbnp2.arrays if ff is None else ff["a"]
        with torch.no_grad():
            mpi, mpj, mpv, cand_nb = ms_candidate_pairs(
                pos, self.heavy_mask, self.ms_rcut, self.ms_kmax_list)
            diags, topo = agbnp2_energy(
                a, pos, ms_pi=mpi, ms_pj=mpj, ms_pv=mpv, build_only=True,
                **self.agbnp2.energy_kwargs())
        return (mpi, mpj, mpv), (topo, v2_counts(diags, cand_nb))

    def _force_fn_v2(self, ms_pairs=None, topology=None, ff=None):
        """fn(pos) -> (energy, force, counts) for AGBNP2 + the MM force
        field: forces by autograd (models/agbnp2_torch.py).  With ms_pairs
        and topology (from _v2_build) the tree builds are fixed-topology
        rescans (the stale-topology window) and counts are the build's
        (a rescan cannot overflow); without them every call finds the MS
        candidates and builds both trees.  Replicas pos [R, N, 3] evaluate
        as one batch (energy [R], counts [R, 18]), the MM terms and
        virtual sites per replica, as versions 0/1 run them."""
        ff = self.ff_state() if ff is None else ff
        a, mm, excl = ff["a"], ff.get("mm"), ff.get("mm_excl_mask")
        kw = self.agbnp2.energy_kwargs()
        vs = self.vsites

        def fn(pos):
            if vs is not None:
                pos = project_positions(pos, vs)
            x = pos.detach().requires_grad_(True)
            with torch.enable_grad():
                if topology is not None:
                    topo, counts = topology
                    e = agbnp2_energy(a, x, ms_pi=ms_pairs[0],
                                      ms_pj=ms_pairs[1], ms_pv=ms_pairs[2],
                                      topology=topo, **kw)[0]
                else:
                    mpi, mpj, mpv, cand_nb = ms_candidate_pairs(
                        pos, self.heavy_mask, self.ms_rcut,
                        self.ms_kmax_list)
                    e, diags, _ = agbnp2_energy(a, x, ms_pi=mpi, ms_pj=mpj,
                                                ms_pv=mpv, **kw)
                    counts = v2_counts(diags, cand_nb)
                (grad,) = torch.autograd.grad(e.sum(), x)
            force = -grad
            e = e.detach()
            if mm is not None:
                e_mm, f_mm = self.mm.forces_of(self.mm.energy, pos, mm, excl)
                e = e + e_mm
                force = force + f_mm
            if vs is not None:
                force = spread_forces(force, vs)
            return e, force, counts

        return fn

    def window_build(self, pos, ff, vdw_caps=None, vdw_relax: float = 0.5,
                     relax=None):
        """A rebuild window's start for R replicas pos [R, N, 3] of the
        system (R = 1 for the Simulation's own windows): their neighbor
        lists, the overlap-tree topology of their disjoint union (relax:
        build_tree's birth margin, make_langevin_runner's topology_relax)
        and, with vdw_caps, its compacted WU topology (the ancestor closure
        of the vdW-live rows of the build).  Returns (pairs, topology,
        vdw_topology, (build counts [R, 7], neighbor_max [R], sibling
        maxima [R, 7], WU kept rows [R, 7]))."""
        nrep = pos.shape[0]
        a = union_arrays(ff["a"], nrep, pairs=False)
        pi, pj, pv, nbmax = self.neighbor_fn(pos, self.heavy_mask,
                                             self.rcut_list, self.kmax)
        pos_t = pos.reshape(-1, 3)
        gdr = a["gamma"] / self.agbnp.params.roffset
        lvl1 = T.make_level1(pos_t, a["radii_large"], a["vol_large"], gdr,
                             a["ishydrogen"])
        levels, bdiag = T.build_tree(lvl1, pi, pj, self.agbnp.caps,
                                     pairs_valid=pv, pair_rows=True,
                                     nrep=nrep, relax=relax)
        topo = T.tree_topology(levels)
        vdw_topo = None
        vdw_counts = torch.zeros((nrep, 7), dtype=torch.int64,
                                 device=pos.device)
        if vdw_caps is not None:
            lvl1v = T.make_level1(pos_t, a["radii_vdw"], a["vol_vdw"], -gdr,
                                  a["ishydrogen"])
            vdw_topo, vdw_counts = T.compact_topology(
                T.rescan_volumes(topo, lvl1v), vdw_caps, relax=vdw_relax,
                nrep=nrep)
        return ((pi, pj, pv), topo, vdw_topo,
                (bdiag["counts"], nbmax, bdiag["max_siblings"], vdw_counts))

    def _ensure_vdw_caps(self, relax: float = 0.5, boost: float = 1.5):
        """Static per-level capacities of the compacted WU topology
        (ops/tree.py::compact_topology), sized from the kept-row counts of
        one build + vdW rescan on the current positions (the compaction
        analogue of the neighbor-list sizing pass).  Cached per relax
        value; _regrow updates the cache on overflow."""
        cached = self._vdw_caps
        if cached is not None and cached[0] == relax:
            return cached[1]
        a = self.agbnp.arrays
        pos = self.positions
        pi, pj, pv, _ = self.neighbor_fn(pos, self.heavy_mask,
                                         self.rcut_list, self.kmax)
        gdr = a["gamma"] / self.agbnp.params.roffset
        lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"], gdr,
                             a["ishydrogen"])
        levels, _ = T.build_tree(lvl1, pi, pj, self.agbnp.caps,
                                 pairs_valid=pv, pair_rows=True)
        lvl1v = T.make_level1(pos, a["radii_vdw"], a["vol_vdw"], -gdr,
                              a["ishydrogen"])
        lv = T.rescan_volumes(T.tree_topology(levels), lvl1v)
        counts = T.compact_topology(lv, [l["valid"].shape[0] for l in lv],
                                    relax=relax)[1][0].cpu().numpy()
        wu = tuple(max(8, int(np.ceil(int(k) * boost / 8) * 8))
                   for k in counts)
        self._vdw_caps = (relax, wu)
        return wu

    def _noise_source(self, pos, generator, noise):
        """draw(count) -> a list of `count` standard-normal [N, 3] draws:
        the next entries of `noise` or fresh draws from `generator`, one
        per (sub)step in the order JAX's key splits consume them."""
        if (generator is None) == (noise is None):
            raise ValueError("give exactly one of generator and noise")
        used = 0

        def draw(count: int):
            nonlocal used
            if noise is not None:
                out = [noise[used + i] for i in range(count)]
            else:
                out = [torch.randn(pos.shape, generator=generator,
                                   dtype=pos.dtype, device=pos.device)
                       for _ in range(count)]
            used += count
            return out

        return draw

    def _no_window_diag(self, counts, shake):
        z = torch.zeros(7, dtype=torch.int64, device=self.device)
        return (counts, torch.zeros((), dtype=torch.int64,
                                    device=self.device), z, z, shake)

    def make_langevin_runner(self, dt=0.001, temperature=300.0, friction=1.0,
                             neighbor_every: int = 10,
                             rebuild_topology: bool = True,
                             mts_inner: int = 0, vdw_compact: bool = True,
                             vdw_relax: float = 0.5, wu_every: int = 1,
                             topology_relax=None, mesh=None):
        """Returns run(pos, vel, nsteps, generator=None, noise=None) ->
        (pos, vel, energies [nsteps], diag) with diag = (counts,
        neighbor_max, sibling_max, wu_compact_counts, shake_residual), the
        maxima over the run's windows (shake_residual None without
        constraints).

        Every `neighbor_every` steps the half neighbor list and, with
        rebuild_topology, the overlap-tree topology are rebuilt; the steps
        of the window run fixed-topology rescans (rebuild_topology=False:
        a tree build every step from the window's list).  topology_relax
        (below 1) keeps the window tree's birth-margin rows, nodes whose
        raw volume is above VOLMINA * topology_relax, so volumes that drift
        across the switching threshold during the window stay in it
        (build_tree's relax; they contribute 0 at the build).  With
        neighbor_every <= 0 every step runs the all-pairs evaluation, and
        the counts are read once, at the end of the run.

        vdw_compact (with rebuild_topology, the default as in JAX): each
        rebuild also extracts the compacted WU topology, and the WU force
        pass of every step runs over it (exact at the rebuild point).
        wu_every > 1 applies the WU force as an r-RESPA impulse every
        wu_every steps (a remainder block closes a window that wu_every
        does not divide).  mts_inner > 0 makes each step an r-RESPA outer
        step of length dt with mts_inner bonded substeps; nsteps and
        neighbor_every then count outer steps.

        The Langevin noise comes from `generator` or, when given, from
        noise [nsteps * max(mts_inner, 1), N, 3], one draw per (sub)step.
        The window's diagnostics are read once at its end; a window that
        overflowed, or whose SHAKE missed tolerance, stops the run (its
        forces are invalid) and its counts come back for the regrow.

        With mesh (an `atoms` mesh, parallel/sharding.py::atom_mesh), every
        step's tree passes and pair phases run in row blocks over the mesh
        (force_fn(mesh=)); the window's neighbor list and tree build, the
        MM terms and the integrator stay replicated: every rank runs them
        on the same positions and its own generator seeded alike, and ends
        with the same bits.  Version 1 with rebuild windows
        (neighbor_every > 0, rebuild_topology) only; no MTS, no wu_every >
        1, and no vdW-compact WU pass (vdw_compact is ignored, as in JAX).
        """
        if mesh is not None:
            self._check_mesh(mesh)
            if neighbor_every <= 0 or not rebuild_topology:
                raise ValueError("mesh-sharded MD requires topology-rebuild "
                                 "windows (neighbor_every > 0, "
                                 "rebuild_topology=True)")
            if mts_inner or wu_every > 1:
                raise ValueError("mesh-sharded MD runs the plain Langevin "
                                 "step: no MTS (mts_inner) and no WU "
                                 "impulse (wu_every > 1)")
        if wu_every > 1 and (mts_inner or neighbor_every <= 0
                             or self.agbnp.version != 1):
            raise ValueError("wu_every > 1 (mts_wu) requires version 1 "
                             "rebuild-window MD without MTS")
        masses, rcut, kmax = self.masses, self.rcut_list, self.kmax
        heavy = self.heavy_mask
        neighbor_fn = self.neighbor_fn
        cons = self.constraints
        ff = self.ff_state(fuse_mm=False if mesh is not None else None)
        nsub = max(mts_inner, 1)
        use_vdwc = (vdw_compact and rebuild_topology and neighbor_every > 0
                    and self.agbnp2 is None and mesh is None)
        vdw_caps = self._ensure_vdw_caps(vdw_relax) if use_vdwc else None

        def make_step(pairs=None, topology=None, vdw_topology=None):
            if mts_inner:
                slow, fast = self.force_fn(pairs=pairs, topology=topology,
                                           ff=ff, split=True,
                                           vdw_topology=vdw_topology)
                return mts_langevin_step(slow, fast, masses, dt, temperature,
                                         friction, mts_inner,
                                         constraints=cons)
            return langevin_middle_step(
                self.force_fn(pairs=pairs, topology=topology, ff=ff,
                              vdw_topology=vdw_topology, mesh=mesh),
                masses, dt, temperature, friction, constraints=cons)

        def step_noise(draw):
            xi = draw(nsub)
            return xi if mts_inner else xi[0]

        if neighbor_every <= 0:
            def run_strict(pos, vel, nsteps: int, generator=None,
                           noise=None):
                draw = self._noise_source(pos, generator, noise)
                step = make_step()
                energies, counts, shake = [], None, None
                for _ in range(nsteps):
                    pos, vel, e, c, sh = step(pos, vel, step_noise(draw))
                    energies.append(e)
                    counts = running_max(counts, c)
                    shake = running_max(shake, sh)
                return (pos, vel, torch.stack(energies),
                        self._no_window_diag(counts, shake))

            return run_strict

        def window_v2(pos, vel, ninner, draw):
            """One AGBNP2 window: a build, then fixed-topology steps; only
            the build can overflow, so its counts are the window's."""
            ms_pairs, topo = self._v2_build(pos, ff)
            step = make_step(ms_pairs, topo)
            energies, counts, shake = [], None, None
            for _ in range(ninner):
                pos, vel, e, c, sh = step(pos, vel, step_noise(draw))
                energies.append(e)
                counts = running_max(counts, c)
                shake = running_max(shake, sh)
            return pos, vel, energies, self._no_window_diag(counts, shake)

        def window(pos, vel, ninner, draw):
            """One rebuild window: (pos, vel, energies, window diag)."""
            if self.agbnp2 is not None:
                return window_v2(pos, vel, ninner, draw)
            if rebuild_topology:
                pairs, topo, vdw_topo, bdiag = self.window_build(
                    pos[None], ff, vdw_caps, vdw_relax, topology_relax)
                # one system: the build's one replica row
                build_counts, nbmax, sib_max, vdw_counts = (
                    x[0] for x in bdiag)
            else:
                pi, pj, pv, nbmax = neighbor_fn(pos, heavy, rcut, kmax)
                pairs = (pi, pj, pv)
                topo = build_counts = vdw_topo = None
                sib_max = vdw_counts = torch.zeros(7, dtype=torch.int64,
                                                   device=pos.device)
            energies, counts, shake = [], None, None
            if wu_every > 1:
                mk = dict(pairs=pairs, topology=topo, ff=ff,
                          vdw_topology=vdw_topo)
                split_fn = self.force_fn(wu_mode="split", **mk)
                skip_fn = self.force_fn(wu_mode="skip", **mk)
                nblk, remk = divmod(ninner, wu_every)
                blocks = {}
                for k in [wu_every] * nblk + ([remk] if remk else []):
                    if k not in blocks:
                        blocks[k] = wu_impulse_langevin_block(
                            split_fn, skip_fn, masses, dt, temperature,
                            friction, k, constraints=cons)
                    pos, vel, es, c, sh = blocks[k](pos, vel, draw(k))
                    energies.extend(es.unbind(0))
                    counts = running_max(counts, c)
                    shake = running_max(shake, sh)
            else:
                step = make_step(pairs, topo, vdw_topo)
                for _ in range(ninner):
                    pos, vel, e, c, sh = step(pos, vel, step_noise(draw))
                    energies.append(e)
                    counts = running_max(counts, c)
                    shake = running_max(shake, sh)
            if build_counts is not None:
                counts = T.merge_counts(counts, build_counts)
            return pos, vel, energies, (counts, nbmax, sib_max, vdw_counts,
                                        shake)

        def run(pos, vel, nsteps: int, generator=None, noise=None):
            draw = self._noise_source(pos, generator, noise)
            energies = []
            diag = None
            done = 0
            while done < nsteps:
                ninner = min(neighbor_every, nsteps - done)
                pos, vel, es, wdiag = window(pos, vel, ninner, draw)
                energies.extend(es)
                diag = wdiag if diag is None else tuple(
                    running_max(x, y) for x, y in zip(diag, wdiag))
                done += ninner
                if self._check_overflow(*wdiag):  # the window's host read
                    break
            return pos, vel, torch.stack(energies), diag

        return run

    def make_verlet_runner(self, dt=0.001):
        """Returns run(pos, vel, nsteps) -> (pos, vel, pe [nsteps],
        ke [nsteps], diag): velocity Verlet (SHAKE/RATTLE with constraints)
        on the all-pairs evaluation every step; diag as the Langevin
        runner's (counts and the SHAKE residual, read by the caller)."""
        fn = self.force_fn()
        step = velocity_verlet_step(fn, self.masses, dt,
                                    constraints=self.constraints)

        def run(pos, vel, nsteps: int):
            _, force, _ = fn(pos)
            pe, ke, counts, shake = [], [], None, None
            for _ in range(nsteps):
                pos, vel, force, e, k, c, sh = step(pos, vel, force)
                pe.append(e)
                ke.append(k)
                counts = running_max(counts, c)
                shake = running_max(shake, sh)
            return (pos, vel, torch.stack(pe), torch.stack(ke),
                    self._no_window_diag(counts, shake))

        return run

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark_langevin(self, nsteps=1000, dt=0.001, temperature=300.0,
                           friction=1.0, seed=0, warmup=True,
                           neighbor_every: int = 10,
                           rebuild_topology: bool = True,
                           mts_inner: int = 0, max_regrow: int = 3,
                           vdw_compact: bool = True, wu_every: int = 1):
        """Timed Langevin MD, reference-benchmark style.  Returns dict with
        ns/day and the energy trace.  If a capacity overflow is detected
        (PanicButton, reference OpenCLAGBNPKernels.cpp:3598-3634) the caps
        are regrown and the whole timed run repeats, up to max_regrow
        times, so the numbers come from a clean run.  A run stops at its
        first overflowed window; if the last allowed attempt still
        overflowed, the dict says overflow=True and reports what ran:
        steps_run (< nsteps), ns_day and steps_per_s computed from it, and
        an energy trace of that length.  The noise generator
        is seeded from `seed` for the warm-up and again for the timed run.
        The defaults are the JAX package's (vdw_compact=True, wu_every=1,
        mts_inner=0): bench.py's strict run; wu_every=4 is its headline
        mts_wu4 run, and dt=0.004, mts_inner=2 with constraints=True and
        neighbor_every=10 its mts4fs_constraints run."""
        for attempt in range(max_regrow + 1):
            run = self.make_langevin_runner(
                dt, temperature, friction, neighbor_every=neighbor_every,
                rebuild_topology=rebuild_topology, mts_inner=mts_inner,
                vdw_compact=vdw_compact, wu_every=wu_every)
            pos, vel = self.positions, self.velocities
            if warmup:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                run(pos, vel, nsteps, generator=gen)
                self._sync()
            gen = torch.Generator(device=self.device).manual_seed(seed)
            t0 = time.perf_counter()
            pos, vel, energies, diag = run(pos, vel, nsteps, generator=gen)
            self._sync()
            elapsed = time.perf_counter() - t0
            overflow = self._check_overflow(*diag)
            if not overflow or attempt == max_regrow:
                break
            self._regrow(*diag)
        counts, nbmax, shake = diag[0], diag[1], diag[4]
        steps_run = int(energies.shape[0])
        return dict(ns_day=steps_run * dt * 1e-3 / elapsed * 86400.0,
                    elapsed_s=elapsed, steps_per_s=steps_run / elapsed,
                    steps_run=steps_run, final_pos=pos, final_vel=vel,
                    tree_counts_max=counts.cpu().numpy(),
                    neighbor_max=int(nbmax), overflow=overflow,
                    regrows=attempt, energies=energies.cpu().numpy(),
                    shake_residual=None if shake is None else float(shake))

    def _check_overflow(self, counts, nbmax, sibs, wu=None,
                        shake=None) -> bool:
        return bool(self.overflow_report(counts, nbmax, sibs, wu, shake))

    def overflow_report(self, counts, nbmax, sibs, wu=None,
                        shake=None) -> dict:
        """Which PanicButton channels overflowed: {channel: (seen, cap)}.
        Empty dict = clean run.  Channels: tree level caps, sibling
        enumeration windows, neighbor kmax (which also carries a cell-grid
        capacity overflow as kmax + 1), the compacted-WU per-level caps
        (wu_compact_level*), the interacting-tile-list budgets
        (tile_list_born, tile_list_gb), and the SHAKE residual against the
        constraint tolerance (shake_residual)."""
        rep = {}
        counts = np.asarray(torch.as_tensor(counts).cpu())
        if shake is not None and self.constraints is not None:
            tol = self.constraints.tolerance(self.dtype)
            resid = float(shake)
            if not resid <= tol:
                rep["shake_residual"] = (resid, tol)
        if self.agbnp2 is not None:
            rep.update(self._overflow_report_v2(counts))
            return rep
        sibs = np.asarray(torch.as_tensor(sibs).cpu())
        caps = self.agbnp.caps
        for i, (c, c0) in enumerate(zip(counts[:len(caps.caps)], caps.caps)):
            if int(c) > int(c0):
                rep[f"tree_level{i + 1}"] = (int(c), int(c0))
        # the deepest level's sibling groups are never enumerated further
        # (MAX_ORDER truncation, reference gaussvol.cpp:211)
        for i, (sb, o0) in enumerate(zip(sibs[:len(caps.offs)], caps.offs)):
            if int(sb) - 1 > int(o0):
                rep[f"sibling_window{i + 1}"] = (int(sb) - 1, int(o0))
        if int(nbmax) > self.kmax:
            rep["neighbor_kmax"] = (int(nbmax), int(self.kmax))
        if wu is not None and self._vdw_caps is not None:
            # a WU kept-row count past its compact capacity means live rows
            # were truncated out of the WU force pass
            for i, (k, o) in enumerate(zip(
                    np.asarray(torch.as_tensor(wu).cpu()),
                    self._vdw_caps[1])):
                if int(k) > int(o):
                    rep[f"wu_compact_level{i + 1}"] = (int(k), int(o))
        ncaps = len(caps.caps)
        if counts.shape[0] > ncaps and self.agbnp.pair_tiles is not None:
            # trailing entries: interacting-tile-list in-range counts
            cb, cg = counts[ncaps:ncaps + 2]
            lb, lg = self.agbnp.pair_tiles
            if int(cb) > int(lb):
                rep["tile_list_born"] = (int(cb), int(lb))
            if lg is not None and int(cg) > int(lg):
                rep["tile_list_gb"] = (int(cg), int(lg))
        return rep

    def _overflow_report_v2(self, c) -> dict:
        """The AGBNP2 channels of overflow_report over v2_counts' vector
        (JAX md/simulation.py::_check_overflow_v2): both trees' level caps,
        cap_ms, the MS tree's neighbor width, the MS candidate list's width
        and the MS subtraction lists' width."""
        m2 = self.agbnp2
        rep = {}
        for name, counts, caps in (("tree_level", c[:7], m2.caps.caps),
                                   ("ms_tree_level", c[7:14],
                                    m2.caps_ms.caps)):
            for i, (k, k0) in enumerate(zip(counts, caps)):
                if int(k) > int(k0):
                    rep[f"{name}{i + 1}"] = (int(k), int(k0))
        for name, k, k0 in (("ms_count", c[14], m2.cap_ms),
                            ("ms_tree_kmax", c[15], m2.ms_kmax),
                            ("ms_candidate_kmax", c[16], self.ms_kmax_list),
                            ("ms_subtraction_k", c[17], m2.ms_sub_k)):
            # the subtraction lists exist only with ms_sub_k > 0
            if int(k) > int(k0) and (name != "ms_subtraction_k" or k0 > 0):
                rep[name] = (int(k), int(k0))
        return rep

    def _regrow_v2(self, counts, headroom: float = 1.3):
        """PanicButton resize for AGBNP2 (JAX md/simulation.py::
        _regrow_v2): the atomic and MS tree caps, cap_ms and the three list
        widths grow past the measured maxima, and the model is rebuilt."""
        c = np.asarray(torch.as_tensor(counts).cpu())
        m2 = self.agbnp2

        def grow_caps(old, seen):
            return T.TreeCaps(
                caps=tuple(max(c0, 2 * c0 if int(k) > c0 else c0,
                               _align(int(k) * headroom))
                           for c0, k in zip(old.caps, seen)),
                offs=old.offs)

        cap_ms = m2.cap_ms
        if int(c[14]) > cap_ms:
            cap_ms = _align(int(c[14]) * 1.5)
        ms_kmax = m2.ms_kmax
        if int(c[15]) > ms_kmax:
            ms_kmax = _kmax_for(int(c[15]))
        if int(c[16]) > self.ms_kmax_list:
            self.ms_kmax_list = _kmax_for(int(c[16]))
        ms_sub_k = m2.ms_sub_k
        if ms_sub_k > 0 and int(c[17]) > ms_sub_k:
            ms_sub_k = _kmax_for(int(c[17]))
        self.agbnp2 = AGBNP2Model(m2.params, device=self.device,
                                  dtype=self.dtype,
                                  positions=np.asarray(self.dms.positions),
                                  cutoff=m2.cutoff,
                                  caps=grow_caps(m2.caps, c[:7]),
                                  caps_ms=grow_caps(m2.caps_ms, c[7:14]),
                                  cap_ms=cap_ms, ms_kmax=ms_kmax,
                                  ms_sub_k=ms_sub_k,
                                  pair_kernel=m2.pair_kernel)
        self.agbnp = self.agbnp2

    def _regrow(self, counts, nbmax, sibs, wu=None, shake=None,
                headroom: float = 1.3):
        """PanicButton resize (reference OpenCLAGBNPKernels.cpp:340-343,
        3598-3634): rebuild the model with capacities covering the measured
        maxima plus headroom, grow the WU-compact caps past their kept-row
        counts, and give SHAKE two more Newton sweeps if it missed its
        tolerance.  Runners built before this call are stale."""
        if (shake is not None and self.constraints is not None
                and not float(shake) <= self.constraints.tolerance(
                    self.dtype)):
            self.constraints.sweeps = min(self.constraints.sweeps + 2,
                                          self.constraints.max_iter)
        if self.agbnp2 is not None:
            return self._regrow_v2(counts, headroom)
        old = self.agbnp.caps
        counts = np.asarray(torch.as_tensor(counts).cpu())
        # trailing tile-list counts: grow the model's budgets before the
        # rebuild below copies them over
        if counts.shape[0] > len(old.caps):
            self.agbnp.grow_pair_tiles(counts[len(old.caps):len(old.caps) + 2])

        # a truncated level hides its children, so measured counts
        # underestimate deeper levels: overflowed levels at least double
        caps = tuple(max(c0, 2 * c0 if int(c) > c0 else c0,
                         _align(int(c) * headroom))
                     for c0, c in zip(old.caps, counts[:len(old.caps)]))
        sibs = np.asarray(torch.as_tensor(sibs).cpu())
        offs = tuple(max(o0, 2 * o0 if int(sb) - 1 > o0 else o0,
                         int(np.ceil(max(int(sb) - 1, 1) * headroom)))
                     for o0, sb in zip(old.offs, sibs[:-1]))
        if wu is not None and self._vdw_caps is not None:
            relax, old_wu = self._vdw_caps
            wu = np.asarray(torch.as_tensor(wu).cpu())
            new_wu = tuple(max(o, 2 * o if int(k) > o else o,
                               max(8, int(np.ceil(int(k) * headroom / 8) * 8)))
                           for o, k in zip(old_wu, wu))
            self._vdw_caps = (relax, new_wu)
        if int(nbmax) > self.kmax:
            if self.grid is not None:
                # a cell-capacity overflow reports kmax+1 through this
                # channel; regrow the grid capacity alongside kmax
                self._set_grid(None, self.grid.grown())
            self.kmax = _kmax_for(int(nbmax))
        m = self.agbnp
        self.agbnp = AGBNPModel(m.params, device=self.device, dtype=self.dtype,
                                caps=T.TreeCaps(caps=caps, offs=offs),
                                version=m.version, cutoff=m.cutoff,
                                positions=np.asarray(self.dms.positions),
                                descreen_horizon=m.descreen_horizon,
                                pair_tiles=(m.pair_tiles if m.pair_tiles
                                            is not None else False),
                                share_qd=m.share_qd,
                                pair_kernel=m.pair_kernel, pairs=self.pairs)

    def run_md(self, nsteps, dt=0.001, temperature=300.0, friction=1.0,
               seed=0, neighbor_every: int = 20, segment: int | None = None,
               max_regrow: int = 8, pos=None, vel=None, generator=None,
               mts_inner: int = 0, report_interval: int = 0, reporter=None,
               checkpoint_path: str | None = None):
        """Langevin MD with automatic PanicButton recovery.

        Runs in segments; when a segment overflowed any capacity channel
        (or its SHAKE missed tolerance), its results are discarded, the
        capacities are regrown from the measured maxima with escalating
        headroom, and the segment is retried from its starting state
        (positions, velocities and generator state): the MD-loop form of
        the reference's PanicButton protocol (OpenCLAGBNPKernels.cpp:
        3598-3634).  Returns the same dict as benchmark_langevin plus
        'regrows'.

        report_interval > 0 collects a position snapshot every that many
        steps (it becomes the segment size): the dict gains 'frames'
        [F, N, 3] (numpy) and 'frame_steps'; write them with
        io.dcd.write_dcd.  `reporter(step, pos, vel)` is called per
        snapshot when given.  Snapshots come only from clean segments.

        checkpoint_path writes an exact-resume checkpoint (io/checkpoint.py)
        after every clean segment.  Resuming with `ck =
        load_checkpoint(p); run_md(nsteps - ck['step'],
        pos=ck['positions'], vel=ck['velocities'],
        generator=restore_generator(ck), ...)` (same dt, segment and
        neighbor_every) reproduces the uninterrupted trajectory bitwise.
        `generator` (advanced in place) overrides the seed.
        """
        if report_interval:
            if segment is not None and segment != report_interval:
                raise ValueError("segment and report_interval conflict; "
                                 "give one of them")
            segment = max(int(report_interval), 1)
        elif neighbor_every <= 0:
            # the all-pairs evaluation every step: any segment size works
            segment = min(nsteps, 50) if segment is None else segment
        else:
            if segment is None:
                segment = min(nsteps, 50 * neighbor_every)
            segment -= segment % neighbor_every
            segment = max(segment, min(nsteps, neighbor_every))
        if segment <= 0:
            raise ValueError(f"segment {segment} must be positive")

        def runner():
            return self.make_langevin_runner(
                dt, temperature, friction, neighbor_every=neighbor_every,
                mts_inner=mts_inner)

        run = runner()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        pos = self.positions if pos is None else torch.as_tensor(
            pos, dtype=self.dtype, device=self.device)
        vel = self.velocities if vel is None else torch.as_tensor(
            vel, dtype=self.dtype, device=self.device)
        energies = []
        frames, frame_steps = [], []
        done = 0
        regrows = 0
        t0 = time.perf_counter()
        while done < nsteps:
            n = min(segment, nsteps - done)
            state = generator.get_state()
            new_pos, new_vel, e, diag = run(pos, vel, n, generator=generator)
            if self._check_overflow(*diag):
                if regrows >= max_regrow:
                    raise RuntimeError(
                        "capacities failed to converge after "
                        f"{max_regrow} regrows: {self.overflow_report(*diag)}")
                regrows += 1
                # escalating headroom: every capacity channel drifts up
                # together on a thermalizing system, so growing the margin
                # per retry collapses incremental regrows
                self._regrow(*diag,
                             headroom=min(1.3 * 1.25 ** (regrows - 1), 2.6))
                run = runner()
                generator.set_state(state)
                continue  # retry the segment from (pos, vel, generator)
            pos, vel = new_pos, new_vel
            energies.append(e.cpu().numpy())
            done += n
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, done, pos, vel, generator,
                                meta=dict(dt=dt, temperature=temperature,
                                          friction=friction,
                                          neighbor_every=neighbor_every,
                                          segment=segment, nsteps=nsteps))
            if report_interval:
                frames.append(pos.detach().cpu().numpy())
                frame_steps.append(done)
                if reporter is not None:
                    reporter(done, pos, vel)
        elapsed = time.perf_counter() - t0
        out = dict(ns_day=nsteps * dt * 1e-3 / elapsed * 86400.0,
                   elapsed_s=elapsed, steps_per_s=nsteps / elapsed,
                   final_pos=pos, final_vel=vel, regrows=regrows,
                   energies=np.concatenate(energies),
                   tree_counts_max=diag[0].cpu().numpy(),
                   neighbor_max=int(diag[1]), overflow=False)
        if report_interval:
            out["frames"] = np.stack(frames)
            out["frame_steps"] = np.asarray(frame_steps)
        return out
