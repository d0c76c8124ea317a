"""Holonomic X-H distance constraints (SHAKE/RATTLE) on tensors.

Counterpart of the JAX package's md/constraints.py.  The benchmark systems
carry Desmond constraint tables (constraint_ah{1,2,3}: one heavy atom and
1-3 hydrogens at fixed distances), which the reference applies through
DesmondDMSFile.createSystem (reference example/trpcage_benchmark.py:11).
Those tables form a star forest: independent clusters of one heavy atom X
and up to 3 hydrogens.  The coupled Lagrange system is then block diagonal
with <= 3x3 blocks, so RATTLE is one exact batched 3x3 solve and SHAKE is
Newton iteration with the same analytic block inverse (quadratic
convergence).

Where JAX iterates SHAKE under a lax.while_loop on a device-side residual,
the star path here runs a fixed number of Newton sweeps (`sweeps`) and
returns the final residual as a device tensor: no host read inside an MD
step.  The MD runner reads the residual once per window and refuses a
window whose SHAKE did not reach tolerance, as it refuses an overflow
(md/simulation.py: the `shake_residual` channel, regrown by adding sweeps).
Tables that are not a star forest take the global Jacobi iteration, whose
convergence test reads the host once per sweep: the slow path, kept for
generality (no shipped .dms needs it).

The star path's scatters have unique indices (one cluster per heavy atom,
each hydrogen in one cluster), so a plain indexed add is deterministic;
the Jacobi path, whose atoms can sit in several constraints, adds through
the deterministic segment sum.  Results are the same from run to run on
the GPU too.

Replicas: positions and velocities [R, N, 3] (the replica runners) are
constrained per replica, every gather, add and contraction on the atom
axis, and shake's residual is [R] (0-d for one system [N, 3]).  The star
path's fixed sweeps treat each replica alone.  The Jacobi path stops
when every replica has converged and freezes a converged replica while
the others iterate (what JAX's vmapped lax.while_loop does), so replica r
comes out as it would alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tree import batched_segment_sum

_KMAX = 3  # constraint_ah1..3: at most 3 hydrogens per heavy atom
# Newton sweeps of the star-cluster SHAKE: from a 2 fs drift the residual
# reaches float32 round-off in 4 (3 leave up to ~3e-6 on 1li2); a window
# that misses the tolerance gets more through the MD runner's regrow
_SWEEPS = 4
# nm of drift beyond the DMS positions' largest coordinate, for the
# float32 tolerance floor
_DRIFT_MARGIN = 1.0


def _star_clusters(idx, d, masses):
    """Group [nc,2] (heavy, hydrogen) constraints into star clusters.

    Returns None unless every hydrogen appears exactly once, no atom is
    both heavy and hydrogen, and no heavy atom exceeds _KMAX hydrogens.
    """
    a, b = idx[:, 0], idx[:, 1]
    if len(set(b)) != len(b) or (set(a) & set(b)):
        return None
    order = np.argsort(a, kind="stable")
    groups = {}
    for k in order:
        groups.setdefault(int(a[k]), []).append(k)
    if max(len(g) for g in groups.values()) > _KMAX:
        return None
    ncl = len(groups)
    cx = np.zeros(ncl, np.int64)
    ch = np.zeros((ncl, _KMAX), np.int64)
    cd = np.ones((ncl, _KMAX), np.float64)
    cmask = np.zeros((ncl, _KMAX), bool)
    cimh = np.ones((ncl, _KMAX), np.float64)
    for i, (x, rows) in enumerate(sorted(groups.items())):
        cx[i] = x
        for j, k in enumerate(rows):
            ch[i, j] = b[k]
            cd[i, j] = d[k]
            cmask[i, j] = True
            cimh[i, j] = 1.0 / masses[b[k]]
    return dict(cx=cx, ch=ch, cd=cd, cmask=cmask,
                cimx=1.0 / masses[cx], cimh=cimh)


def _solve3(A, rhs):
    """Batched 3x3 solve by adjugate, with a sign-preserving determinant
    floor: degenerate cluster geometry (collinear X-H bonds after a hard
    collision) makes A singular, and the floor keeps lambda finite."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)) ** 3,
                        min=1e-30)
    floor = 1e-12 * scale
    det = torch.where(torch.abs(det) > floor, det,
                      torch.where(det < 0, -floor, floor))
    x0 = co00 * rhs[..., 0] + co01 * rhs[..., 1] + co02 * rhs[..., 2]
    x1 = co10 * rhs[..., 0] + co11 * rhs[..., 1] + co12 * rhs[..., 2]
    x2 = co20 * rhs[..., 0] + co21 * rhs[..., 1] + co22 * rhs[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


class Constraints:
    """A fixed set of pairwise distance constraints.

    idx: [nc, 2] atom indices (heavy, hydrogen); d: [nc] target distances
    (nm); masses: [N]; device: where the tables live (no default).  tol is
    the relative distance tolerance (OpenMM integrator constraint-tolerance
    semantics), floored per compute dtype (`tolerance`); extent: the
    largest absolute coordinate (nm) the positions reach, which sets how
    finely a distance can be represented.  max_iter bounds the Jacobi
    fallback; `sweeps`, the fixed Newton sweep count of the star-cluster
    SHAKE, is raised by the MD runner's regrow.
    """

    def __init__(self, idx, d, masses, *, device, tol: float = 1e-8,
                 max_iter: int = 200, extent: float = 0.0):
        idx = np.asarray(idx, np.int64).reshape(-1, 2)
        dev = torch.device(device)
        self.n_constraints = idx.shape[0]
        self.extent = float(extent)
        self.d_min = float(np.min(d)) if self.n_constraints else 1.0
        masses = np.asarray(masses, np.float64)
        self.a = torch.as_tensor(idx[:, 0], device=dev)
        self.b = torch.as_tensor(idx[:, 1], device=dev)
        self.d = torch.as_tensor(np.asarray(d, np.float64), device=dev)
        self.inv_ma = torch.as_tensor(1.0 / masses[idx[:, 0]], device=dev)
        self.inv_mb = torch.as_tensor(1.0 / masses[idx[:, 1]], device=dev)
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.sweeps = _SWEEPS
        self.clusters = None
        self._cast = {}
        if self.n_constraints:
            cl = _star_clusters(idx, np.asarray(d, np.float64), masses)
            if cl is not None:
                # the hydrogen slots actually used: the scatter of their
                # corrections then has unique indices
                slots = np.nonzero(cl["cmask"].reshape(-1))[0]
                cl["hslot"] = slots
                cl["hatom"] = cl["ch"].reshape(-1)[slots]
                self.clusters = {k: torch.as_tensor(v, device=dev)
                                 for k, v in cl.items()}

    @staticmethod
    def from_dms(dms, *, device, tol: float = 1e-8):
        """The DMS constraint tables; extent = the largest coordinate of
        the DMS positions plus 1 nm of drift."""
        if dms.constraint_idx.size == 0:
            return None
        return Constraints(dms.constraint_idx, dms.constraint_d, dms.masses,
                           device=device, tol=tol,
                           extent=float(np.abs(dms.positions).max())
                           + _DRIFT_MARGIN)

    def tolerance(self, dtype) -> float:
        """Effective tolerance: the requested one, floored at what the
        compute dtype can express.  JAX's floor is 30 eps (in float32 a
        1e-8 relative residual is below round-off); positions of magnitude
        `extent` lie on a grid of spacing ~eps*extent, so no constrained
        distance can be held closer than eps*extent*sqrt(3)/d_min (in
        float32 on 1li2, ~1.3e-5), and the floor is the larger of the
        two."""
        eps = float(torch.finfo(dtype).eps)
        return max(self.tol, 30.0 * eps,
                   eps * self.extent * 3 ** 0.5 / self.d_min)

    def _fields(self, dtype):
        """The cluster tables with their floats in `dtype` (cached)."""
        f = self._cast.get(dtype)
        if f is None:
            cl = self.clusters
            f = (cl["cx"], cl["ch"], cl["cd"].to(dtype), cl["cmask"],
                 cl["cimx"].to(dtype), cl["cimh"].to(dtype), cl["hslot"],
                 cl["hatom"])
            self._cast[dtype] = f
        return f

    def _scatter(self, x, dx_heavy, dh):
        """x[cx] += dx_heavy; x[hydrogens] += dh [..., ncl, K, 3] (used
        slots only): unique indices, so one add per atom."""
        cx, _, _, _, _, _, hslot, hatom = self._fields(x.dtype)
        x = x.index_add(-2, cx, dx_heavy)
        dh = dh.reshape(dh.shape[:-3] + (-1, 3))
        return x.index_add(-2, hatom, dh[..., hslot, :])

    # ------------------------------------------------------------------
    # block-direct star-cluster solvers (the fast path)
    # ------------------------------------------------------------------

    def _residual_clustered(self, x):
        cx, ch, d, mask, _, _, _, _ = self._fields(x.dtype)
        d2 = d * d
        r = x[..., cx, None, :] - x[..., ch, :]
        diff = torch.where(mask, torch.sum(r * r, dim=-1) - d2, 0.0)
        return diff, r, d2

    def _positions_clustered(self, x, x_ref):
        """SHAKE as `sweeps` Newton iterations with exact 3x3 block solves
        (each sweep solves the coupled linearized system of a cluster)."""
        cx, ch, _, mask, imx, imh, _, _ = self._fields(x.dtype)
        rref = x_ref[..., cx, None, :] - x_ref[..., ch, :]  # [.., ncl, K, 3]
        eye = torch.eye(_KMAX, dtype=x.dtype, device=x.device)
        pad = mask[:, :, None] & mask[:, None, :]
        for _ in range(self.sweeps):
            diff, r, d2 = self._residual_clustered(x)
            # A_ij = 2 [imX (r_i . rref_j) + delta_ij imH_i (r_i . rref_i)]
            rdot = torch.einsum("...cid,...cjd->...cij", r, rref)
            diag = torch.einsum("...cid,...cid->...ci", r, rref)
            # rotated-past-perpendicular guard (as the Jacobi path's)
            diag = torch.where(torch.abs(diag) > 1e-12 * d2, diag, d2)
            rdot = rdot * (1.0 - eye) + diag[..., None] * eye
            A = 2.0 * (imx[:, None, None] * rdot
                       + eye * (imh * diag)[..., None])
            # padded constraints: identity row/col, zero rhs -> lambda = 0
            A = torch.where(pad, A, eye)
            lam = torch.where(mask, _solve3(A, diff), 0.0)
            dxh = lam[..., None] * rref
            x = self._scatter(x, -imx[:, None] * torch.sum(dxh, dim=-2),
                              imh[:, :, None] * dxh)
        diff, _, d2 = self._residual_clustered(x)
        return x, 0.5 * torch.amax(torch.abs(diff) / d2, dim=(-2, -1))

    def _velocities_clustered(self, x, v):
        """RATTLE is linear in v: one exact block solve, no iteration."""
        cx, ch, _, mask, imx, imh, _, _ = self._fields(v.dtype)
        r = x[..., cx, None, :] - x[..., ch, :]           # [.., ncl, K, 3]
        rv = torch.einsum("...cid,...cid->...ci", r,
                          v[..., cx, None, :] - v[..., ch, :])
        rv = torch.where(mask, rv, 0.0)
        eye = torch.eye(_KMAX, dtype=v.dtype, device=v.device)
        rr = torch.einsum("...cid,...cjd->...cij", r, r)
        A = (imx[:, None, None] * rr
             + eye * (imh * torch.einsum("...cid,...cid->...ci", r,
                                         r))[..., None])
        pad = mask[:, :, None] & mask[:, None, :]
        A = torch.where(pad, A, eye)
        lam = torch.where(mask, _solve3(A, rv), 0.0)
        dvh = lam[..., None] * r
        return self._scatter(v, -imx[:, None] * torch.sum(dvh, dim=-2),
                             imh[:, :, None] * dvh)

    # ------------------------------------------------------------------
    # global Jacobi iteration (tables that are not a star forest)
    # ------------------------------------------------------------------

    def _jacobi_tables(self, dtype):
        return (self.a, self.b, self.d.to(dtype), self.inv_ma.to(dtype),
                self.inv_mb.to(dtype))

    def _scatter_pairs(self, x, da, db):
        """x[a] += da; x[b] += db, through the deterministic segment sum
        (an atom may sit in several constraints)."""
        n = x.shape[-2]
        return ((x + batched_segment_sum(da, self.a, n))
                + batched_segment_sum(db, self.b, n))

    @staticmethod
    def _frozen(active, new, old):
        """new where a replica is still iterating (active [...]), old where
        it has converged."""
        return torch.where(active[..., None, None], new, old)

    def _positions_jacobi(self, x, x_ref):
        a, b, d, ima, imb = self._jacobi_tables(x.dtype)
        rref = x_ref[..., a, :] - x_ref[..., b, :]
        d2 = d * d
        # |r^2 - d^2| / (2 d^2) ~ relative distance error, the OpenMM
        # constraint-tolerance convention
        tol2 = 2.0 * self.tolerance(x.dtype)

        def residual(x):
            r = x[..., a, :] - x[..., b, :]
            return torch.sum(r * r, dim=-1) - d2, r

        for _ in range(self.max_iter):
            diff, r = residual(x)
            active = torch.amax(torch.abs(diff) / d2, dim=-1) > tol2
            if not bool(torch.any(active)):  # host
                break
            rr = torch.sum(r * rref, dim=-1)
            # if the bond rotated past perpendicular the linearized step is
            # invalid; fall back to the current direction
            rr = torch.where(torch.abs(rr) > 1e-12 * d2, rr, d2)
            g = diff / (2.0 * (ima + imb) * rr)
            dx = g[..., None] * rref
            x = self._frozen(active, self._scatter_pairs(
                x, -ima[:, None] * dx, imb[:, None] * dx), x)
        diff, _ = residual(x)
        return x, 0.5 * torch.amax(torch.abs(diff) / d2, dim=-1)

    def _velocities_jacobi(self, x, v):
        a, b, d, ima, imb = self._jacobi_tables(v.dtype)
        r = x[..., a, :] - x[..., b, :]
        d2 = d * d
        im = ima + imb
        # velocity tolerance: relative rate |r.dv| / d^2 (1/ps units)
        vtol = self.tolerance(v.dtype)
        for _ in range(self.max_iter):
            rate = torch.sum(r * (v[..., a, :] - v[..., b, :]), dim=-1)
            active = torch.amax(torch.abs(rate) / d2, dim=-1) > vtol
            if not bool(torch.any(active)):  # host
                break
            dv = (rate / (im * d2))[..., None] * r
            v = self._frozen(active, self._scatter_pairs(
                v, -ima[:, None] * dv, imb[:, None] * dv), v)
        return v

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def shake(self, x, x_ref):
        """SHAKE: project x onto the constraint manifold using reference
        directions from x_ref (the pre-step constrained positions).
        Returns (x, residual) with residual the largest relative distance
        error left on x.device, per replica for x [R, N, 3] ([R]; 0-d for
        x [N, 3]; compare with tolerance(x.dtype))."""
        if self.n_constraints == 0:
            return x, x.new_zeros(x.shape[:-2])
        if self.clusters is not None:
            return self._positions_clustered(x, x_ref)
        return self._positions_jacobi(x, x_ref)

    def positions(self, x, x_ref):
        """SHAKE without the residual (the JAX package's API)."""
        return self.shake(x, x_ref)[0]

    def velocities(self, x, v):
        """RATTLE: remove velocity components along the (current)
        constraint directions so d/dt |r|^2 = 0."""
        if self.n_constraints == 0:
            return v
        if self.clusters is not None:
            return self._velocities_clustered(x, v)
        return self._velocities_jacobi(x, v)

    def max_violation(self, x):
        """Worst relative distance error (diagnostic): a 0-d tensor for x
        [N, 3], [R] for x [R, N, 3]."""
        if self.n_constraints == 0:
            return x.new_zeros(x.shape[:-2])
        d = self.d.to(x.dtype)
        r = x[..., self.a, :] - x[..., self.b, :]
        return torch.amax(torch.abs(torch.sqrt(torch.sum(r * r, dim=-1)) - d)
                          / d, dim=-1)
