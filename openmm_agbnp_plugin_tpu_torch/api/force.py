"""Public AGBNPForce API, mirroring the reference plugin's surface.

Reference: openmmapi/include/AGBNPForce.h:39-155 and AGBNPForce.cpp.
A user of the reference builds the force with
    force = AGBNPForce(); force.setVersion(1)
    force.addParticle(radius, gamma, alpha, charge, ishydrogen) x N
and evaluates energy/forces through a Context.  Here the Context binds the
force to the PyTorch compute path (AGBNPModel) instead of an OpenMM platform
kernel; the parameter-validation semantics (version in {0,1,2}, single
common gamma across heavy atoms, hydrogen gamma zeroing) match the
reference (AGBNPForce.cpp:52-59, ReferenceAGBNPKernels.cpp:96-118).  The
same classes as the JAX package's api/force.py, with one more Context
argument: the device.  Versions 0 and 1 evaluate through AGBNPModel,
version 2 through AGBNP2Model (built at the first evaluation, since its MS
sizing needs positions; its MS candidates picked anew at every
setPositions).  Every evaluation retries through the PanicButton loop
while a capacity overflows.  Version 2 takes no periodic box.
"""

from __future__ import annotations

import enum
import warnings

import numpy as np
import torch

from ..models.agbnp2_torch import AGBNP2Model
from ..models.agbnp_torch import AGBNPModel
from ..models.constants import AGBNP_RADIUS_INCREMENT, SOLVENT_RADIUS
from ..models.params import AGBNPParams


class NonbondedMethod(enum.IntEnum):
    """Long-range handling (AGBNPForce.h:44-59)."""

    NoCutoff = 0
    CutoffNonPeriodic = 1
    CutoffPeriodic = 2


class AGBNPForce:
    """Particle table + model options for the AGBNP implicit-solvent force."""

    def __init__(self):
        self._particles: list[tuple] = []
        self._nonbonded_method = NonbondedMethod.NoCutoff
        self._cutoff = 1.0
        self._version = 1
        self._solvent_radius = SOLVENT_RADIUS
        self._force_group = 0

    # -- particle table (AGBNPForce.h:61-103) ------------------------------

    def addParticle(self, radius: float, gamma: float, vdw_alpha: float,
                    charge: float, ishydrogen: bool) -> int:
        self._particles.append((float(radius), float(gamma), float(vdw_alpha),
                                float(charge), bool(ishydrogen)))
        return len(self._particles) - 1

    def setParticleParameters(self, index: int, radius, gamma, vdw_alpha,
                              charge, ishydrogen):
        self._particles[index] = (float(radius), float(gamma),
                                  float(vdw_alpha), float(charge),
                                  bool(ishydrogen))

    def getParticleParameters(self, index: int):
        return self._particles[index]

    def getNumParticles(self) -> int:
        return len(self._particles)

    # -- options -----------------------------------------------------------

    def setVersion(self, version: int):
        if version not in (0, 1, 2):
            raise ValueError(
                "AGBNPForce: illegal version number, should be 0, 1 or 2")
        self._version = version

    def getVersion(self) -> int:
        return self._version

    def setNonbondedMethod(self, method):
        self._nonbonded_method = NonbondedMethod(method)

    def getNonbondedMethod(self) -> NonbondedMethod:
        return self._nonbonded_method

    def setCutoffDistance(self, distance: float):
        self._cutoff = float(distance)

    def getCutoffDistance(self) -> float:
        return self._cutoff

    def getSolventRadius(self) -> float:
        return self._solvent_radius

    def setForceGroup(self, group: int):
        """Force-group index in [0, 31] (the OpenMM Force base-class
        semantics the reference inherits; AGBNPForceImpl evaluates only
        when the group bit is in the caller's mask,
        openmmapi/src/AGBNPForceImpl.cpp:32-36)."""
        group = int(group)
        if not 0 <= group <= 31:
            raise ValueError("force group must be between 0 and 31")
        self._force_group = group

    def getForceGroup(self) -> int:
        return self._force_group

    # -- binding -----------------------------------------------------------

    def to_params(self) -> AGBNPParams:
        """Validated parameter arrays (the kernel-initialize step,
        ReferenceAGBNPKernels.cpp:58-137)."""
        if not self._particles:
            raise ValueError("AGBNPForce has no particles")
        arr = np.array([p[:4] for p in self._particles], dtype=np.float64)
        ish = np.array([p[4] for p in self._particles], dtype=np.int64)
        gammas = arr[:, 1]
        heavy = ish == 0
        if heavy.any():
            g0 = gammas[heavy][0]
            if np.any((gammas[heavy] - g0) ** 2 > 1.1754943508222875e-38):
                raise ValueError(
                    "AGBNP does not support multiple gamma values.")
        return AGBNPParams(radius=arr[:, 0], gamma=gammas, alpha=arr[:, 2],
                           charge=arr[:, 3], ishydrogen=ish,
                           roffset=AGBNP_RADIUS_INCREMENT)

    def updateParametersInContext(self, context):
        """Push edited particle parameters into a live Context
        (AGBNPForce.cpp:76-78)."""
        context.reinitialize_force(self)


class Context:
    """Binds an AGBNPForce to the PyTorch compute path.

    The analogue of creating an OpenMM Context on a platform: it prepares
    the device arrays and serves getState(energy, forces)-style queries.

    device: where the arrays live and every evaluation runs.  None means
    the first CUDA device and raises where there is none; pass "cpu" to
    evaluate on the host (the pair phases then run their plain twins).  On a
    CUDA device the version 1 pair phases are float32 CUDA kernels, so dtype
    must be torch.float32 there; version 2 runs them at float32 and its
    plain phases at float64.

    Energies come back as Python floats and forces as a [N, 3] tensor of
    `dtype` on the Context's device (calcForcesAndEnergy's zeros included).
    """

    def __init__(self, force: AGBNPForce, dtype=torch.float32, caps=None,
                 box=None, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Context: no CUDA device; pass device='cpu' to evaluate "
                    "on the host")
            device = "cuda:0"
        self._device = torch.device(device)
        self._dtype = dtype
        self._caps = caps
        self._box = None
        self._force = None
        self._model = None
        self._model_box = None  # the box the model was built with (f64)
        if box is not None:
            self.setPeriodicBoxVectors(*box)
        self.reinitialize_force(force)
        self._positions = None

    def setPeriodicBoxVectors(self, a, b, c):
        """Periodic box (used with CutoffPeriodic): orthorhombic or
        reduced-form triclinic, the general OpenMM periodic-box semantics
        the reference inherits (AGBNPForce.h:55).  Triclinic vectors must
        be in OpenMM reduced form — a=(ax,0,0), b=(bx,by,0), c=(cx,cy,cz)
        with |bx|,|cx| <= ax/2 and |cy| <= by/2 — under which the
        sequential c/b/a minimum-image wrap (ops/born.py::min_image) is
        exact for pair distances below half the box widths.  The pair
        phases then use minimum-image deltas."""
        vecs = np.array([a, b, c], dtype=np.float64)
        if not np.allclose(vecs[np.triu_indices(3, 1)], 0.0):
            raise ValueError(
                "box vectors must be in reduced form: a=(ax,0,0), "
                "b=(bx,by,0), c=(cx,cy,cz)")
        ax, by, cz = np.diag(vecs)
        if ax <= 0 or by <= 0 or cz <= 0:
            raise ValueError("box lengths must be positive")
        if (abs(vecs[1, 0]) > 0.5 * ax or abs(vecs[2, 0]) > 0.5 * ax
                or abs(vecs[2, 1]) > 0.5 * by):
            raise ValueError(
                "triclinic box is not in reduced form (|bx|,|cx| <= ax/2, "
                "|cy| <= by/2); reduce the lattice vectors first")
        # orthorhombic boxes keep the compact [3] representation (the
        # component-wise wrap in every pair sweep)
        if np.allclose(vecs, np.diag(np.diag(vecs))):
            self._box = np.diag(vecs).copy()
        else:
            self._box = vecs
        if self._force is not None:
            self.reinitialize_force(self._force)

    def getPeriodicBoxVectors(self):
        """The three box vectors as rows of a [3, 3] array (None when no
        box is set)."""
        if self._box is None:
            return None
        if self._box.ndim == 1:
            return np.diag(self._box)
        return self._box.copy()

    def reinitialize_force(self, force: AGBNPForce):
        cutoff = (None if force.getNonbondedMethod() == NonbondedMethod.NoCutoff
                  else force.getCutoffDistance())
        periodic = force.getNonbondedMethod() == NonbondedMethod.CutoffPeriodic
        if periodic and self._box is None:
            raise ValueError(
                "CutoffPeriodic requires setPeriodicBoxVectors (or the box= "
                "Context argument)")
        if periodic and force.getVersion() == 2:
            raise NotImplementedError(
                "version 2 takes no periodic box: its MS stage and pair "
                "phases run without one (NoCutoff or CutoffNonPeriodic)")
        self._force = force
        if force.getVersion() == 2:
            # AGBNP2: the model is built at the first evaluation, since its
            # MS sizing needs positions
            self._model = None
            self._model_box = None
            return
        params = force.to_params()
        box = self._box if periodic else None
        old = self._model
        if (old is not None
                and old.version == force.getVersion() != 2
                and old.cutoff == cutoff
                and ((self._model_box is None) == (box is None))
                and (box is None or np.array_equal(self._model_box, box))
                and old.params.n == params.n
                and np.array_equal(np.asarray(old.params.ishydrogen),
                                   np.asarray(params.ishydrogen))):
            # parameter-only update: swap the arrays, keep the model, its
            # capacities and its layouts (the reference re-uploads device
            # arrays, AGBNPForce.cpp:76-78 -> copyParametersToContext)
            old.update_params(params)
            return
        # no positions yet, as in the JAX package: heuristic capacities
        # that the PanicButton loop grows, and the dense pair grid
        self._model = AGBNPModel(params, device=self._device,
                                 dtype=self._dtype,
                                 version=force.getVersion(), cutoff=cutoff,
                                 caps=self._caps, box=box)
        self._model_box = None if box is None else box.copy()

    def setPositions(self, positions):
        self._positions = np.asarray(positions, dtype=np.float64)
        if isinstance(self._model, AGBNP2Model):
            self._model.set_positions(self._positions)
        if self._box is not None:
            # The overlap tree uses raw deltas (like every reference
            # backend): overlaps span <~0.7 nm and assume an unwrapped
            # solute.  Coordinates wrapped across the periodic boundary
            # would silently break the cavity term, so guard on extent.
            extent = self._positions.max(axis=0) - self._positions.min(axis=0)
            widths = (self._box if self._box.ndim == 1
                      else np.diag(self._box))
            if (extent > 0.75 * widths).any():
                warnings.warn(
                    "solute extent approaches the periodic box; if the "
                    "coordinates are wrapped across the boundary the "
                    "cavity (overlap-tree) term will be wrong — provide "
                    "unwrapped solute coordinates (the pair phases alone "
                    "use minimum-image)", RuntimeWarning)

    def _evaluate(self, evaluate):
        """evaluate() -> (result, out) retried through the PanicButton
        resize loop while a capacity overflows (version 2: both overlap
        trees, cap_ms and the MS list widths, from capacities sized at the
        first positions; the JAX package evaluates version 2 once)."""
        if self._positions is None:
            raise ValueError("call setPositions first")
        v2 = self._force.getVersion() == 2
        if v2 and self._model is None:
            cutoff = (None if self._force.getNonbondedMethod()
                      == NonbondedMethod.NoCutoff
                      else self._force.getCutoffDistance())
            self._model = AGBNP2Model(self._force.to_params(),
                                      device=self._device, dtype=self._dtype,
                                      positions=self._positions,
                                      cutoff=cutoff)
        for _ in range(8):
            result, out = evaluate()
            if not self._model.check_and_grow(out["diags" if v2 else "diag"]):
                return result
        raise RuntimeError("overlap tree capacities failed to converge")

    def getEnergyForces(self):
        """(energy, forces) of the positions set last."""
        def full():
            e, f, out = self._model.energy_forces(self._positions,
                                                  with_details=True)
            return (e, f), out

        e, f = self._evaluate(full)
        return float(e), f

    def getEnergy(self):
        """Energy-only evaluation.  Skips the WU gamma-rescan tree pass
        entirely (that pass carries force only; the energy never depends on
        it) — the includeForces=False path of the reference's
        AGBNPForceImpl::calcForcesAndEnergy
        (openmmapi/src/AGBNPForceImpl.cpp:32-36)."""
        if self._force.getVersion() == 2:
            return self.getEnergyForces()[0]
        return float(self._evaluate(lambda: self._model.energy_only(
            self._positions, with_details=True)))

    def getForces(self):
        """Forces-only evaluation (includeEnergy=False).  The analytic
        force chain subsumes every energy intermediate, so this is the full
        evaluation returning only the force tensor."""
        return self.getEnergyForces()[1]

    def calcForcesAndEnergy(self, includeForces: bool = True,
                            includeEnergy: bool = True, groups: int = -1):
        """Flagged evaluation with a force-group mask — the exact surface
        of AGBNPForceImpl::calcForcesAndEnergy (reference
        openmmapi/src/AGBNPForceImpl.cpp:32-36): the force contributes only
        when bit getForceGroup() is set in `groups`; the return is
        (energy, forces) with energy 0.0 when not included and forces all
        zero when not included (the reference adds nothing to the force
        buffer in those cases)."""
        n = self._force.getNumParticles()
        zeros = torch.zeros((n, 3), dtype=self._dtype, device=self._device)
        if (int(groups) & (1 << self._force.getForceGroup())) == 0:
            return 0.0, zeros
        if includeForces:
            e, f = self.getEnergyForces()
            return (e if includeEnergy else 0.0), f
        if includeEnergy:
            return self.getEnergy(), zeros
        return 0.0, zeros
