"""Langevin MD of a DMS system with AGBNP1 implicit solvent + OPLS.

Counterpart of the JAX package's md/simulation.py for the configuration
its MD benchmark runs (bench.py): AGBNP version 1 with the pair sweeps on
the kernel route (over interacting-tile lists by default, as in JAX) and
the MM dense LJ + Coulomb sum fused into the GB sweep, rebuild windows (a
half neighbor list, through a cell grid above 3000 atoms, and an
overlap-tree topology every `neighbor_every` steps, fixed-topology rescans
in between), and the WU gamma-rescan force pass every step.  The JAX
runner's `lax.scan` over the steps of a window is a Python loop here;
per-step overflow counts (tree levels and tile lists) stay on the device
and the host reads them once per window.

What lies outside this configuration (versions 0/2, MTS, constraints,
virtual sites, the vdW-compact WU topology, WU impulses, mesh sharding)
is not ported: there is no option for it, and version != 1 raises.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..models.agbnp_torch import AGBNPModel, energy_forces
from ..models.params import AGBNPParams
from ..ops import tree as T
from ..ops.neighbors import CellGrid, cell_neighbor_pairs, \
    half_neighbor_pairs, host_max_neighbors, tree_pair_cutoff
from .forces import MMForceField
from .integrators import langevin_middle_step


class Simulation:
    """MD simulation of a DMS system with AGBNP implicit solvent (the
    reference benchmark scripts' DesmondDMSFile.createSystem(
    implicitSolvent='AGBNP') + LangevinIntegrator + Simulation.step).

    device: where every array lives and every step runs (no default);
    dtype: float64 for CPU parity work, float32 on the GPU (the CUDA pair
    kernels take float32 only).  pair_tiles and share_qd go to AGBNPModel
    (interacting-tile-list budgets, None = sized from the initial
    positions; Q/dQ sharing between the Born and descreening sweeps).
    """

    def __init__(self, dms, *, device, version: int = 1,
                 cutoff: float | None = None, dtype=torch.float64,
                 caps=None, skin: float = 0.15, kmax: int | None = None,
                 descreen_horizon=None, pair_tiles=None,
                 share_qd: bool = True):
        if version != 1:
            raise ValueError(f"version {version}: MD is ported for "
                             "AGBNP version 1 only")
        self.dms = dms
        self.device = torch.device(device)
        self.dtype = dtype
        params = AGBNPParams(radius=dms.agbnp_radius, gamma=dms.agbnp_gamma,
                             alpha=dms.agbnp_alpha, charge=dms.charges,
                             ishydrogen=dms.ishydrogen)
        self.agbnp = AGBNPModel(params, device=self.device, dtype=dtype,
                                version=1, cutoff=cutoff, caps=caps,
                                positions=dms.positions,
                                descreen_horizon=descreen_horizon,
                                pair_tiles=pair_tiles, share_qd=share_qd)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.mm = MMForceField.from_dms(dms, cutoff=cutoff, dtype=np_dtype)
        self.masses = torch.as_tensor(dms.masses, dtype=dtype,
                                      device=self.device)
        self.positions = torch.as_tensor(dms.positions, dtype=dtype,
                                         device=self.device)
        self.velocities = torch.as_tensor(dms.velocities, dtype=dtype,
                                          device=self.device)

        # neighbor-list sizing pass (the analogue of the reference's CPU
        # GaussVol pre-pass, OpenCLAGBNPKernels.cpp:566-617)
        self.rcut_list = tree_pair_cutoff(params.radii_large) + skin
        heavy = np.asarray(params.ishydrogen) == 0
        if kmax is None:
            seen = host_max_neighbors(np.asarray(dms.positions), heavy,
                                      self.rcut_list)
            kmax = int(np.ceil(seen * 1.5 / 16) * 16)
        self.kmax = kmax
        self.heavy_mask = torch.as_tensor(heavy, device=self.device)
        # O(N) cell-grid neighbor build above the dense-rebuild crossover
        # (the analogue of OpenMM's cell-based tiles the reference rides)
        self.grid = None
        if params.n > 3000:
            self.grid = CellGrid(np.asarray(dms.positions), self.rcut_list,
                                 heavy_mask=heavy)
        self.neighbor_fn = (functools.partial(cell_neighbor_pairs,
                                              grid=self.grid)
                            if self.grid is not None else half_neighbor_pairs)

    def ff_state(self) -> dict:
        """Force-field tensors the MD step reads: the AGBNP arrays, the MM
        arrays, and the exclusion rows in the pair sweeps' Morton-permuted
        row space (rows reordered, atom-id values remapped)."""
        a = self.agbnp.arrays_np
        er = self.mm.excl_rows()
        rinv = a["rinv"]
        epm = np.where(er >= 0, rinv[np.clip(er, 0, None)], -1)
        return dict(a=self.agbnp.arrays,
                    mm=self.mm.tensors(self.device, self.dtype),
                    excl_rows_perm=torch.as_tensor(
                        epm[a["rperm"]].astype(np.int32),
                        device=self.device))

    def force_fn(self, pairs=None, topology=None, ff=None):
        """Returns fn(pos) -> (energy, force, counts).

        AGBNP1 energy + analytic forces with the OPLS dense LJ + Coulomb
        sum riding the GB sweep; bonded terms and 1-4 pairs by autograd.
        pairs: (pairs_i, pairs_j, pairs_valid) from the neighbor list (the
        tree's 2-body candidates); topology: a tree_topology() of an
        earlier build (fixed-topology rescans).  counts: the tree-level
        counts, followed by the in-range Born and GB tile counts when the
        sweeps run on interacting-tile lists."""
        ff = self.ff_state() if ff is None else ff
        m = self.agbnp
        a = ff["a"]
        if pairs is not None:
            a = {**a, "pairs_i": pairs[0], "pairs_j": pairs[1],
                 "pairs_valid": pairs[2]}
        mm_nb = dict(sigma=ff["mm"]["sigma"], epsq=ff["mm"]["epsq"],
                     excl_rows_perm=ff["excl_rows_perm"])

        def fn(pos):
            out = energy_forces(a, pos, caps=m.caps, version=m.version,
                                roffset=m.params.roffset,
                                ntypes_j=m.ntypes_j, cutoff=m.cutoff,
                                topology=topology, box=m.box,
                                pair_pad=m.pair_pad,
                                pair_rows=pairs is not None, mm_nb=mm_nb,
                                descreen_horizon=m.descreen_horizon,
                                pair_tiles=m.pair_tiles,
                                share_qd=m.share_qd)
            energy = out["energy"] + out["details"]["e_mm_nb"]
            e_mm, f_mm = self.mm.bonded_and_14_forces(pos, ff["mm"])
            counts = out["diag"]["counts"].long()
            ptc = out["diag"].get("pair_tile_counts")
            if ptc is not None:
                # the tile-list counts ride the tree counts' overflow
                # channel (split off again in overflow_report)
                counts = torch.cat([counts, ptc.long()])
            return energy + e_mm, out["force"] + f_mm, counts

        return fn

    def make_langevin_runner(self, dt=0.001, temperature=300.0, friction=1.0,
                             neighbor_every: int = 10):
        """Returns run(pos, vel, nsteps, generator=None, noise=None) ->
        (pos, vel, energies [nsteps], (counts, neighbor_max, sibling_max)).

        Every `neighbor_every` steps the half neighbor list (neighbor_fn)
        and the overlap-tree topology are rebuilt; the steps of the window run
        fixed-topology rescans.  The Langevin noise comes
        from `generator` or, when given, from noise [nsteps, N, 3].  The
        window's overflow counts are read once at its end; a window that
        overflowed stops the run (its forces are invalid) and its counts
        come back for the PanicButton regrow.
        """
        if neighbor_every <= 0:
            raise ValueError("neighbor_every must be > 0 (rebuild windows)")
        masses, rcut, kmax = self.masses, self.rcut_list, self.kmax
        heavy = self.heavy_mask
        neighbor_fn = self.neighbor_fn
        caps = self.agbnp.caps
        roffset = self.agbnp.params.roffset
        ff = self.ff_state()
        a = ff["a"]

        def run(pos, vel, nsteps: int, generator=None, noise=None):
            if (generator is None) == (noise is None):
                raise ValueError("give exactly one of generator and noise")
            energies = []
            diag = None
            done = 0
            while done < nsteps:
                ninner = min(neighbor_every, nsteps - done)
                pi, pj, pv, nbmax = neighbor_fn(pos, heavy, rcut, kmax)
                lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"],
                                     a["gamma"] / roffset, a["ishydrogen"])
                levels, bdiag = T.build_tree(lvl1, pi, pj, caps,
                                             pairs_valid=pv, pair_rows=True)
                topo = T.tree_topology(levels)
                step = langevin_middle_step(
                    self.force_fn(pairs=(pi, pj, pv), topology=topo, ff=ff),
                    masses, dt, temperature, friction)
                wcounts = []
                for s in range(ninner):
                    xi = (noise[done + s] if noise is not None else
                          torch.randn(pos.shape, generator=generator,
                                      dtype=pos.dtype, device=pos.device))
                    pos, vel, e, counts = step(pos, vel, xi)
                    energies.append(e)
                    wcounts.append(counts)
                wmax = T.merge_counts(
                    torch.max(torch.stack(wcounts), dim=0).values,
                    bdiag["counts"])
                wdiag = (wmax, nbmax, bdiag["max_siblings"])
                diag = wdiag if diag is None else tuple(
                    torch.maximum(x, y) for x, y in zip(diag, wdiag))
                done += ninner
                if self._check_overflow(*wdiag):
                    break
            return pos, vel, torch.stack(energies), diag

        return run

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark_langevin(self, nsteps=1000, dt=0.001, temperature=300.0,
                           friction=1.0, seed=0, warmup=True,
                           neighbor_every: int = 10, max_regrow: int = 3):
        """Timed Langevin MD, reference-benchmark style.  Returns dict with
        ns/day and the energy trace.  If a capacity overflow is detected
        (PanicButton, reference OpenCLAGBNPKernels.cpp:3598-3634) the caps
        are regrown and the whole timed run repeats, up to max_regrow
        times, so the numbers come from a clean run.  The noise generator
        is seeded from `seed` for the warm-up and again for the timed run.

        The JAX runner's vdw_compact, wu_every and mts_inner options are
        not ported: this is its vdw_compact=False, wu_every=1, mts_inner=0
        path."""
        for attempt in range(max_regrow + 1):
            run = self.make_langevin_runner(dt, temperature, friction,
                                            neighbor_every=neighbor_every)
            pos, vel = self.positions, self.velocities
            if warmup:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                run(pos, vel, nsteps, generator=gen)
                self._sync()
            gen = torch.Generator(device=self.device).manual_seed(seed)
            t0 = time.perf_counter()
            pos, vel, energies, (counts, nbmax, sibs) = run(
                pos, vel, nsteps, generator=gen)
            self._sync()
            elapsed = time.perf_counter() - t0
            counts = counts.cpu().numpy()
            nbmax = int(nbmax)
            sibs = sibs.cpu().numpy()
            overflow = self._check_overflow(counts, nbmax, sibs)
            if not overflow or attempt == max_regrow:
                break
            self._regrow(counts, nbmax, sibs)
        return dict(ns_day=nsteps * dt * 1e-3 / elapsed * 86400.0,
                    elapsed_s=elapsed, steps_per_s=nsteps / elapsed,
                    final_pos=pos, final_vel=vel, tree_counts_max=counts,
                    neighbor_max=nbmax, overflow=overflow, regrows=attempt,
                    energies=energies.cpu().numpy())

    def _check_overflow(self, counts, nbmax, sibs) -> bool:
        return bool(self.overflow_report(counts, nbmax, sibs))

    def overflow_report(self, counts, nbmax, sibs) -> dict:
        """Which PanicButton channels overflowed: {channel: (seen, cap)}.
        Empty dict = clean run.  Channels: tree level caps, sibling
        enumeration windows, neighbor kmax (which also carries a cell-grid
        capacity overflow as kmax + 1), and the interacting-tile-list
        budgets (tile_list_born, tile_list_gb)."""
        rep = {}
        counts = np.asarray(torch.as_tensor(counts).cpu())
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

    def _regrow(self, counts, nbmax, sibs, headroom: float = 1.3):
        """PanicButton resize (reference OpenCLAGBNPKernels.cpp:340-343,
        3598-3634): rebuild the model with capacities covering the measured
        maxima plus headroom.  Runners built before this call are stale."""
        old = self.agbnp.caps
        counts = np.asarray(counts)
        # trailing tile-list counts: grow the model's budgets before the
        # rebuild below copies them over
        if counts.shape[0] > len(old.caps):
            self.agbnp.grow_pair_tiles(counts[len(old.caps):len(old.caps) + 2])

        def r(x, align=128):
            return max(align, int(np.ceil(x / align)) * align)

        # a truncated level hides its children, so measured counts
        # underestimate deeper levels: overflowed levels at least double
        caps = tuple(max(c0, 2 * c0 if int(c) > c0 else c0,
                         r(int(c) * headroom))
                     for c0, c in zip(old.caps, counts[:len(old.caps)]))
        sibs = np.asarray(sibs)
        offs = tuple(max(o0, 2 * o0 if int(sb) - 1 > o0 else o0,
                         int(np.ceil(max(int(sb) - 1, 1) * headroom)))
                     for o0, sb in zip(old.offs, sibs[:-1]))
        if int(nbmax) > self.kmax:
            if self.grid is not None:
                # a cell-capacity overflow reports kmax+1 through this
                # channel; regrow the grid capacity alongside kmax
                self.grid = self.grid.grown()
                self.neighbor_fn = functools.partial(cell_neighbor_pairs,
                                                     grid=self.grid)
            self.kmax = int(np.ceil(int(nbmax) * 1.5 / 16) * 16)
        m = self.agbnp
        self.agbnp = AGBNPModel(m.params, device=self.device, dtype=self.dtype,
                                caps=T.TreeCaps(caps=caps, offs=offs),
                                version=m.version, cutoff=m.cutoff,
                                positions=np.asarray(self.dms.positions),
                                descreen_horizon=m.descreen_horizon,
                                pair_tiles=(m.pair_tiles if m.pair_tiles
                                            is not None else False),
                                share_qd=m.share_qd)
