"""Sharding over torch.distributed: replica blocks and atom-sharded AGBNP1.

Counterpart of the JAX package's parallel/sharding.py.  JAX runs one
process over a device mesh (shard_map); here each rank is a process of a
torch.distributed process group, and a mesh is that group seen from one
rank (`Mesh`: group, rank, size, device, axis name).  Two axes, as in JAX:

  * `replica` (replica_mesh): independent replicas or poses, a contiguous
    block a rank (ReplicaEnsemble, TemperatureREMD and ConformerScorer take
    mesh=); results come back by all_gather.
  * `atoms` (atom_mesh): one system's fixed-topology AGBNP1 evaluation with
    the overlap tree's levels and the pair phases' screened-atom rows in
    row blocks, one a rank (sharded_energy_forces; Simulation.force_fn and
    make_langevin_runner take mesh=).  The tree build, the MM terms and the
    integrator stay replicated.

Every collective is a list all_gather (TreeComm; a sum across ranks adds
the gathered parts in rank order, so every rank holds the same bits) and
is recorded in ops/tree.py's comm log under the JAX package's names.

run_ranks(fn, world, ...) starts `world` ranks as spawned processes with a
file:// rendezvous, runs fn in each and returns their results; the
counterpart of the JAX package's virtual 8-device CPU mesh.  Its backend
is NCCL when every rank has a card of its own and gloo otherwise (CPU
ranks, or ranks sharing one card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..ops import born as B
from ..ops import tree as T

# the device of a rank started by run_ranks (its meshes' default device)
_RANK_DEVICE = None
# seconds run_ranks waits for the other ranks' reports after one failed
FAILURE_GRACE = 3.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a process group used as a one-axis mesh."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str

    @property
    def comm(self) -> T.TreeComm:
        return T.TreeComm(self.group, self.rank, self.size)

    def block(self, total: int) -> slice:
        """This rank's contiguous block of `total` items (a multiple of
        the size)."""
        if total % self.size:
            raise ValueError(f"{total} items do not split into {self.size} "
                             f"equal blocks over the {self.axis!r} mesh")
        nb = total // self.size
        return slice(self.rank * nb, (self.rank + 1) * nb)

    def gather(self, x):
        """Every rank's block x [nb, ...] in rank order: [size nb, ...]."""
        return T.gather_blocks(x, self.group, self.size)


def _rank_device() -> torch.device:
    """The device of this rank: run_ranks' choice for its ranks, else the
    card of index rank modulo the card count (raising without a card)."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' "
                           "to run the mesh on the host")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _mesh(axis: str, group, device) -> Mesh:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{axis} mesh: torch.distributed is not initialised; start the "
            "ranks with parallel.sharding.run_ranks or "
            "torch.distributed.init_process_group")
    device = _rank_device() if device is None else torch.device(device)
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=device, axis=axis)


def atom_mesh(group=None, device=None) -> Mesh:
    """The `atoms` mesh over `group` (None: the default process group)."""
    return _mesh("atoms", group, device)


def replica_mesh(group=None, device=None) -> Mesh:
    """The `replica` mesh over `group` (None: the default process group)."""
    return _mesh("replica", group, device)


def make_replica_ensemble_step(step_fn, mesh: Mesh):
    """A per-replica step over the `replica` mesh: run(states) applies
    step_fn(state) -> state to this rank's block of the replicas and
    gathers the results.  states: a tuple of tensors stacked on a leading
    replica axis (the same on every rank); returns them stacked likewise
    (JAX sharding.py:35-54, whose vmap is a loop over the block here)."""
    def run(states):
        blk = mesh.block(states[0].shape[0])
        outs = [step_fn(tuple(x[r] for x in states))
                for r in range(blk.start, blk.stop)]
        return tuple(mesh.gather(torch.stack([o[i] for o in outs]))
                     for i in range(len(states)))

    return run


def _logged_collective(kind: str, mesh: Mesh):
    """A psum or all_gather over the mesh, recorded in the comm log."""
    def psum(x):
        T.record_comm("psum", x, mesh.size)
        return T.sum_over_ranks(x, mesh.group, mesh.size)

    def all_gather(x):
        T.record_comm("all_gather", x, mesh.size)
        return T.gather_blocks(x, mesh.group, mesh.size)

    return dict(psum=psum, all_gather=all_gather)[kind]


def _padded_rows(a: dict, pos, mesh: Mesh):
    """This rank's block of the screened-atom rows, padded to a multiple of
    the mesh size: padded rows sit far away with zero charge and alpha and
    radius 0.1 nm, so every padded contribution is zero (JAX
    sharding.py:110-116).  Returns (n, the block's rows dict)."""
    n = pos.shape[0]
    npad = -(-n // mesh.size) * mesh.size
    pad = npad - n
    dt, dev = pos.dtype, pos.device
    far = 1e3 * (1.0 + 0.618 * torch.arange(pad, dtype=dt, device=dev))
    pos_p = torch.cat([pos, torch.stack([far, far, far], dim=-1)], dim=0)

    def padded(x, fill=0.0):
        return torch.nn.functional.pad(x, (0, pad), value=fill)

    blk = mesh.block(npad)
    rows = dict(pos=pos_p[blk],
                ids=torch.arange(npad, device=dev)[blk],
                radii=padded(a["radii_vdw"].to(dt), 0.1)[blk],
                type_i=padded(a["type_i"])[blk],
                charge=padded(a["charge"].to(dt))[blk],
                alpha=padded(a["alpha"].to(dt))[blk])
    return n, rows


def _arrays(a: dict, device) -> dict:
    """A prepare_arrays dict (numpy) or an arrays_from_numpy one as tensors
    on device (floats kept in their dtype; cast per call)."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v, device=device)
            for k, v in a.items()}


def _pair_rows(mesh, a, rows, pos, s_factor, ntypes_j, cutoff, box,
               horizon):
    dt = pos.dtype
    return B.pair_phases_rows(
        rows["pos"], rows["ids"], pos, rows["radii"], s_factor,
        a["ishydrogen"], rows["type_i"], a["type_j"], a["yflat"].to(dt),
        a["y2flat"].to(dt), ntypes_j, rows["charge"], a["charge"].to(dt),
        rows["alpha"], cutoff=cutoff, box=box,
        psum=_logged_collective("psum", mesh),
        all_gather=_logged_collective("all_gather", mesh), horizon=horizon)


def _row_force_full(mesh, pp, n):
    """The block's row forces placed at its offset in zeros and summed
    across ranks: the whole [N, 3] on every rank (the JAX package's psum of
    a dynamic_update_slice)."""
    rf = pp["row_force"]
    nblk = rf.shape[0]
    full = torch.zeros((nblk * mesh.size, 3), dtype=rf.dtype,
                       device=rf.device)
    full[mesh.rank * nblk:(mesh.rank + 1) * nblk] = rf
    return _logged_collective("psum", mesh)(full)[:n]


def sharded_pair_phases(mesh: Mesh, a: dict, ntypes_j: int, cutoff=None,
                        box=None):
    """The AGBNP1 pair phases (Born radii -> GB -> vdW -> descreening) with
    the screened-atom rows in blocks over the mesh (JAX
    sharding.py:62-131).  Each rank owns a contiguous row block and the
    whole screener arrays; the collectives are one all_gather (the Born
    radii the GB pair term needs) and psums of the energies, the
    screener-side W/U sums and forces, and the row forces.

    a: the prepare_arrays / arrays_from_numpy dict.  Returns fn(pos,
    s_factor) -> dict(gb_self, gb_pair, e_vdw, born_radius [N], pair_force
    [N, 3], evdw_der_W, egb_der_U), whole on every rank, equal to the dense
    path to f64 roundoff; the `pair_shard` of energy_forces."""
    a = _arrays(a, mesh.device)

    def fn(pos, s_factor):
        n, rows = _padded_rows(a, pos, mesh)
        pp = _pair_rows(mesh, a, rows, pos, s_factor.to(pos.dtype), ntypes_j,
                        cutoff, box, None)
        return dict(gb_self=pp["gb_self"], gb_pair=pp["gb_pair"],
                    e_vdw=pp["e_vdw"], born_radius=pp["born_radius_all"],
                    pair_force=_row_force_full(mesh, pp, n)
                    + pp["col_force"],
                    evdw_der_W=pp["evdw_der_W"], egb_der_U=pp["egb_der_U"])

    return fn


def _shard_topology(topology, mesh: Mesh):
    """This rank's row block of each level of a tree_topology() result:
    the row-aligned leaves the fixed-topology passes read (ids, validity,
    the monotone parent ids and the int32 gather ids, the deposit atoms).
    The per-parent lengths are not row-aligned and are dropped: the row
    blocks sum upward by their parent ids (ops/tree.py).  A level whose
    capacity does not divide by the mesh size raises."""
    out = []
    for t in topology:
        cap = t["valid"].shape[0]
        if cap % mesh.size:
            raise ValueError(f"tree level capacity {cap} not divisible by "
                             f"{mesh.size} ranks")
        blk = mesh.block(cap)
        bnd = {k: t["bnd"][k][blk]
               for k in ("pmono", "pmono32", "atom32", "atom_dep")}
        out.append(dict(_ints=t["_ints"][blk], valid=t["valid"][blk],
                        atom=t["atom"][blk], parent=t["parent"][blk],
                        bnd=bnd))
    return tuple(out)


def sharded_energy_forces(mesh: Mesh, a: dict, roffset: float,
                          ntypes_j: int, cutoff=None, box=None,
                          descreen_horizon=None):
    """The full fixed-topology AGBNP1 evaluation over the `atoms` mesh (JAX
    sharding.py:169-293): the cavity passes (rescan_volumes2 +
    reduce_tree2) and the W/U gamma-rescan force pass on row blocks of the
    overlap tree's levels (TreeComm: each level gathered whole downward,
    summed across ranks upward), the pair phases on row blocks of the
    screened atoms.  The tree build stays replicated: in MD it runs once a
    rebuild window.

    Returns fn(pos, topology, arrays=None) -> dict(energy, force, e_cav,
    self_volume, born_radius), whole and the same bits on every rank, equal
    to the unsharded energy_forces(topology=...) to f64 roundoff.  arrays:
    the force field's arrays dict to use instead of `a` (the MD runners
    pass theirs)."""
    comm = mesh.comm
    a0 = _arrays(a, mesh.device)

    def fn(pos, topology, arrays=None):
        av = a0 if arrays is None else arrays
        dt = pos.dtype
        topo = _shard_topology(topology, mesh)
        gamma_dr = av["gamma"].to(dt) / roffset
        ish = av["ishydrogen"]
        vol_vdw_all = av["vol_vdw_all"].to(dt)
        lvl1_large = T.make_level1(pos, av["radii_large"].to(dt),
                                   av["vol_large"].to(dt), gamma_dr, ish)
        lvl1_vdw = T.make_level1(pos, av["radii_vdw"].to(dt),
                                 av["vol_vdw"].to(dt), -gamma_dr, ish)
        la, lb = T.rescan_volumes2(topo, lvl1_large, lvl1_vdw, comm=comm)
        red1, red2 = T.reduce_tree2(la, lb, lvl1_large, lvl1_vdw, comm=comm)
        e_cav = red1["energy"][0] + red2["energy"][0]
        f_cav = -(red1["dr"] + red2["dr"])
        s_factor = red2["self_volume"] / vol_vdw_all

        n, rows = _padded_rows(av, pos, mesh)
        pp = _pair_rows(mesh, av, rows, pos, s_factor, ntypes_j, cutoff,
                        box, descreen_horizon)

        # self-volume-gradient forces via the fused W+U gamma rescan
        gamma_WU = (pp["evdw_der_W"] + pp["egb_der_U"]) / vol_vdw_all
        lvl1_WU = {**lvl1_vdw, "gamma1i": gamma_WU}
        red_WU = T.reduce_tree(T.rescan_gammas(lb, lvl1_WU, comm=comm),
                               lvl1_WU, with_selfvol=False, comm=comm)

        pair_force = _row_force_full(mesh, pp, n) + pp["col_force"]
        energy = e_cav + pp["gb_self"] + pp["gb_pair"] + pp["e_vdw"]
        force = f_cav + pair_force - red_WU["dr"]
        return dict(energy=energy, force=force, e_cav=e_cav,
                    self_volume=red2["self_volume"],
                    born_radius=pp["born_radius_all"])

    return fn


# --- the ranks ---------------------------------------------------------


def choose_backend(world: int, device) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise (CPU
    ranks, or more ranks than cards: NCCL refuses two ranks on one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _to_host(x):
    """Tensors as numpy arrays (on the host), through tuples, lists and
    dicts: what a rank hands back through the result queue."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank, world, backend, init_method, device, threads,
               timeout, args, results):
    global _RANK_DEVICE
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        _RANK_DEVICE = dev
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            results.put((rank, True, _to_host(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, args=(), backend=None, device=None,
              timeout: float = 600.0, init_file=None, threads=None):
    """Run fn(*args) in `world` ranks of a new process group and return
    their results in rank order (tensors come back as numpy arrays).

    Each rank is a process spawned by torch.multiprocessing (fn must be
    importable: a module-level function), joined to the group through a
    file:// rendezvous at init_file (a fresh file in a new temporary
    directory when None).  device: "cpu" for CPU ranks, or None / "cuda"
    for ranks on the cards, rank r on card r modulo the card count (raising
    without one).  backend None picks with choose_backend and says which on
    stderr.  threads: each rank's torch.set_num_threads (None: the host's
    cores split between the ranks).  A rank that raises, or a run that
    outlasts `timeout` seconds, kills every rank and raises here: a lost
    collective fails instead of hanging."""
    import torch.multiprocessing as mp

    device = "cuda" if device is None else str(device)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device; pass device='cpu' "
                           "for CPU ranks")
    backend = backend or choose_backend(world, device)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    print(f"run_ranks: {world} ranks on {device}, backend {backend}",
          file=sys.stderr, flush=True)
    tmpdir = None
    if init_file is None:
        tmpdir = tempfile.mkdtemp(prefix="agbnp_ranks_")
        init_file = os.path.join(tmpdir, "rendezvous")
    init_method = "file://" + os.path.abspath(str(init_file))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, init_method, device,
                               threads, timeout, tuple(args), results),
                         daemon=True)
             for r in range(world)]
    out = [None] * world
    failed = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for _ in range(world):
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = results.get(timeout=max(left, 0.01))
            except queue_mod.Empty:
                if failed:
                    break
                raise TimeoutError(
                    f"run_ranks: {world} ranks did not finish within "
                    f"{timeout} s") from None
            if ok:
                out[rank] = payload
                continue
            # the other ranks' collectives fail in turn: gather their
            # reports a moment, so the first cause is among them
            failed[rank] = payload
            deadline = min(deadline, time.monotonic() + FAILURE_GRACE)
        if failed:
            raise RuntimeError("".join(
                f"rank {r} of {world} failed:\n{failed[r]}"
                for r in sorted(failed)))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return out
