"""Batched conformer rescoring: score B conformations of one molecule in one
batched evaluation.

Counterpart of the JAX package's api/scoring.py.  The reference plugin
evaluates one conformation per Context call (openmmapi/src/
AGBNPForceImpl.cpp:32-36), so rescoring a pose ensemble costs B serial
round trips.  Here versions 0 and 1 score the whole batch in one
evaluation: the overlap tree of the poses' disjoint union and the pair
kernels' replica axis (one launch each for the batch), as
AGBNPModel.batched_energy_forces runs them.  NoCutoff scores on the dense
tile grid; CutoffNonPeriodic on interacting-tile lists sized from the
representative positions.

Semantics per conformer are those of api.force.Context.getEnergyForces:
the same energy and forces, and the same 8-try PanicButton regrow, from
the worst conformer of the batch (batched_diag_max).  Version 2 scores
the batch in one evaluation too (AGBNP2Model.batched_energy_forces: each
pose's MS candidates found on the device, both overlap trees over the
poses' unions, the dense kernels' replica axis), with the capacities
shared and regrown from the 18-entry overflow counts of the worst pose
(_regrow_v2, JAX's rule).

With mesh (a `replica` mesh, parallel/sharding.py::replica_mesh, one rank
a process), the batch is padded to a multiple of the mesh size with copies
of its last pose and each rank scores its contiguous block (JAX
api/scoring.py:120-132); every rank's overflow counts enter each try's
regrow, so all ranks grow alike, and the results come back from every
rank by all_gather, the padding cut off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..md.minimize import make_fire_runner
from ..models.agbnp2_torch import AGBNP2Model, ms_candidate_pairs, \
    ms_pair_cutoff, v2_counts
from ..models.agbnp_torch import AGBNPModel, batched_diag_max
from ..ops import tree as T
from ..ops.neighbors import host_max_neighbors
from .force import AGBNPForce, NonbondedMethod

_DETAIL_TERMS = ("e_cav", "e_vol1", "e_vol2", "gb_self", "gb_pair", "e_vdw")
_DETAIL_TERMS_V2 = ("e_vol1", "e_vol2", "gb_self", "gb_pair", "e_vdw",
                    "e_ms_vdw", "e_ms_large")
_TRIES = 8


class ConformerScorer:
    """Batched AGBNP scorer over conformations of a fixed particle table.

    force: an AGBNPForce (version 0, 1 or 2; NoCutoff or
        CutoffNonPeriodic).
    positions: representative coordinates [N, 3] or a batch [B, N, 3]
        (its first conformer): they size the tree capacities, order the
        pair layouts and size the tile lists; scoring positions may differ.
    dtype: torch.float32 on a card (the pair kernels' type), float64 for
        parity work on the CPU.
    device: where the batch is scored; None is the first CUDA device and
        raises where there is none.
    caps, caps_boost: tree capacities, or the headroom they are sized with.
    mesh: a `replica` mesh over which the batch is split (None: the whole
        batch in this process); every rank is given the same positions and
        gets the whole results.

    Results are tensors on the scorer's device: "energy" [B] (kJ/mol),
    "force" [B, N, 3] with forces=True, and per-term energies with
    details=True.
    """

    def __init__(self, force: AGBNPForce, positions, dtype=torch.float32,
                 device=None, caps=None, caps_boost: float = 1.6, mesh=None):
        if force.getVersion() not in (0, 1, 2):
            raise ValueError("ConformerScorer supports versions 0, 1 and 2")
        if force.getNonbondedMethod() == NonbondedMethod.CutoffPeriodic:
            raise ValueError(
                "ConformerScorer is for gas-phase/implicit-solvent poses; "
                "CutoffPeriodic is not supported")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ConformerScorer: no CUDA device; pass device='cpu' to "
                    "score on the host")
            device = "cuda:0"
        self.device = torch.device(device)
        self.dtype = dtype
        self._mesh = mesh
        pos = torch.as_tensor(positions, dtype=torch.float64)
        pos0 = (pos[0] if pos.dim() == 3 else pos).numpy()
        no_cutoff = force.getNonbondedMethod() == NonbondedMethod.NoCutoff
        self._cutoff = None if no_cutoff else force.getCutoffDistance()
        self._is_v2 = force.getVersion() == 2
        self._pos0 = pos0
        self._force = force
        self._caps = caps
        self._caps_boost = caps_boost
        self._model = self._build(force.to_params())
        if self._is_v2:
            # the width of the MS candidate lists built on the device: the
            # most heavy neighbors within ms_pair_cutoff over the given
            # poses x 1.5, 16-aligned (JAX api/scoring.py:79-84)
            params = self._model.params
            self._ms_rcut = ms_pair_cutoff(params.radii_vdw)
            heavy = np.asarray(params.ishydrogen) == 0
            self._heavy = torch.as_tensor(heavy, device=self.device)
            poses = (pos if pos.dim() == 3 else pos[None]).numpy()
            seen = max(host_max_neighbors(p, heavy, self._ms_rcut)
                       for p in poses)
            self._ms_kmax_list = int(np.ceil(seen * 1.5 / 16) * 16)

    def _build(self, params):
        if self._is_v2:
            return AGBNP2Model(params, device=self.device, dtype=self.dtype,
                               positions=self._pos0, cutoff=self._cutoff,
                               caps=self._caps)
        # the dense grid without a cutoff, interacting-tile lists with one
        return AGBNPModel(params, device=self.device, dtype=self.dtype,
                          version=self._force.getVersion(),
                          cutoff=self._cutoff, caps=self._caps,
                          caps_boost=self._caps_boost, positions=self._pos0,
                          pair_tiles=None if self._cutoff else False)

    @property
    def model(self):
        return self._model

    def updateParametersInContext(self, force: AGBNPForce | None = None):
        """Parameter-only refresh (AGBNPForce.cpp:76-78 semantics): the
        model's parameter arrays are swapped, its capacities, layouts and
        tile budgets kept (version 2: the model is rebuilt with the new
        parameters and the grown capacities; the MS candidate width
        stays)."""
        self._force = force or self._force
        params = self._force.to_params()
        if self._is_v2:
            self._model = self._build_v2(params)
            return
        self._model.update_params(params)

    def _build_v2(self, params, **grown):
        """An AGBNP2Model of params with the current model's capacities,
        those in `grown` replaced."""
        m2 = self._model
        caps = dict(caps=m2.caps, caps_ms=m2.caps_ms, cap_ms=m2.cap_ms,
                    ms_kmax=m2.ms_kmax, ms_sub_k=m2.ms_sub_k)
        caps.update(grown)
        return AGBNP2Model(params, device=self.device, dtype=self.dtype,
                           positions=self._pos0, cutoff=self._cutoff,
                           **caps)

    def _batch(self, positions):
        pos = torch.as_tensor(positions, dtype=self.dtype, device=self.device)
        if pos.dim() == 2:
            pos = pos[None]
        n = self._force.getNumParticles()
        if pos.dim() != 3 or tuple(pos.shape[1:]) != (n, 3):
            raise ValueError(f"expected positions [B, {n}, 3], got "
                             f"{tuple(pos.shape)}")
        return pos

    def _shard(self, pos):
        """This rank's block of the batch padded to a multiple of the mesh
        size with copies of its last pose (the whole batch without a
        mesh), and the batch size."""
        nb = pos.shape[0]
        if self._mesh is None:
            return pos, nb
        pad = (-nb) % self._mesh.size
        if pad:
            pos = torch.cat([pos, pos[-1:].expand((pad,) + pos.shape[1:])])
        return pos[self._mesh.block(pos.shape[0])], nb

    def _gather(self, res: dict, nb: int) -> dict:
        """Every rank's results, the padding cut off."""
        if self._mesh is None:
            return res
        return {k: self._mesh.gather(v)[:nb] for k, v in res.items()}

    def _all_diag(self, diag: dict) -> dict:
        """A batched diag with every rank's poses (the worst of them decides
        each try's regrow on every rank)."""
        if self._mesh is None:
            return diag
        return {k: self._mesh.gather(torch.as_tensor(v, device=self.device))
                for k, v in diag.items()}

    def score(self, positions, forces: bool = False, details: bool = False):
        """Score a batch of conformations positions [B, N, 3] (or [N, 3],
        a batch of one)."""
        pos, nb = self._shard(self._batch(positions))
        if self._is_v2:
            return self._gather(self._score_v2(pos, forces, details), nb)
        m = self._model
        for _ in range(_TRIES):
            out = m.batched_energy_forces(pos)
            if not m.check_and_grow(batched_diag_max(
                    self._all_diag(out["diag"]))):
                break
        else:
            raise RuntimeError("overlap tree capacities failed to converge")
        res = dict(energy=out["energy"])
        if forces:
            res["force"] = out["force"]
        if details:
            res.update({k: out["details"][k] for k in _DETAIL_TERMS
                        if k in out["details"]})
        return self._gather(res, nb)

    def _score_v2(self, pos, forces: bool, details: bool):
        """AGBNP2: one batched evaluation per try, each pose's MS candidates
        found on the device (ms_candidate_pairs, JAX api/scoring.py:
        150-152), the capacities shared by the batch and regrown from the
        18-entry counts of its worst pose (_regrow_v2)."""
        for _ in range(_TRIES):
            pairs = ms_candidate_pairs(pos, self._heavy, self._ms_rcut,
                                       self._ms_kmax_list)
            out = self._model.batched_energy_forces(pos, ms_pairs=pairs[:3])
            counts = self._mesh.gather(v2_counts(out["diags"], pairs[3])) \
                if self._mesh is not None else v2_counts(out["diags"],
                                                         pairs[3])
            if not self._regrow_v2(
                    torch.amax(counts, dim=0).cpu().numpy()):
                break
        else:
            raise RuntimeError("AGBNP2 capacities failed to converge")
        res = dict(energy=out["energy"])
        if forces:
            res["force"] = out["force"]
        if details:
            res.update({k: out["details"][k] for k in _DETAIL_TERMS_V2})
        return res

    def _regrow_v2(self, c, headroom: float = 1.3) -> bool:
        """The PanicButton of version 2 scoring over the 18-entry counts c
        (v2_counts, the batch's maxima), JAX's rule (api/scoring.py:
        195-236): both trees' levels grow to at least double when
        overflowed and past the counts x headroom, 128-aligned; cap_ms past
        1.5 x the particles; the MS tree's, the candidate lists' and the
        subtraction lists' widths past 1.5 x their maxima, 16-aligned.
        Returns True if the model was rebuilt (a re-score is needed)."""
        m2 = self._model
        over = bool((c[:7] > np.asarray(m2.caps.caps)).any()
                    or (c[7:14] > np.asarray(m2.caps_ms.caps)).any()
                    or int(c[14]) > m2.cap_ms or int(c[15]) > m2.ms_kmax
                    or int(c[16]) > self._ms_kmax_list
                    or int(c[17]) > m2.ms_sub_k)
        if not over:
            return False

        def r(x, align=128):
            return max(align, int(np.ceil(x / align)) * align)

        def k16(x):
            return int(np.ceil(int(x) * 1.5 / 16) * 16)

        def grow_caps(old, counts):
            return T.TreeCaps(
                caps=tuple(max(c0, 2 * c0 if int(k) > c0 else c0,
                               r(int(k) * headroom))
                           for c0, k in zip(old.caps, counts)),
                offs=old.offs)

        if int(c[16]) > self._ms_kmax_list:
            self._ms_kmax_list = k16(c[16])
        self._model = self._build_v2(
            self._force.to_params(), caps=grow_caps(m2.caps, c[:7]),
            caps_ms=grow_caps(m2.caps_ms, c[7:14]),
            cap_ms=(r(int(c[14]) * 1.5) if int(c[14]) > m2.cap_ms
                    else m2.cap_ms),
            ms_kmax=k16(c[15]) if int(c[15]) > m2.ms_kmax else m2.ms_kmax,
            ms_sub_k=(k16(c[17]) if int(c[17]) > m2.ms_sub_k
                      else m2.ms_sub_k))
        return True

    def refine(self, positions, maxiter: int = 200, **fire_kw):
        """FIRE-minimize every conformation (one batch, each pose on its own
        FIRE state), then rescore.  The batched analogue of the reference
        workflow's per-pose simulation.minimizeEnergy() (reference
        example/test_agbnp.py:49).  Returns the score() dict plus
        "positions" [B, N, 3] (minimized) and "energy_trace" [B, maxiter].
        Capacities regrow from the worst tree any pose built at any
        iteration, and the minimization reruns."""
        if self._is_v2:
            raise ValueError("refine() supports versions 0/1; score AGBNP2 "
                             "poses directly or minimize through md/")
        pos, nb = self._shard(self._batch(positions))
        m = self._model
        for _ in range(_TRIES):
            run = make_fire_runner(m.batched_energy_forces, maxiter=maxiter,
                                   **fire_kw)
            pmin, etrace, diag = run(pos)
            if not m.check_and_grow(batched_diag_max(self._all_diag(diag))):
                break
        else:
            raise RuntimeError("overlap tree capacities failed to converge")
        got = self._gather(dict(positions=pmin, energy_trace=etrace), nb)
        res = self.score(got["positions"])
        res.update(got)
        return res
