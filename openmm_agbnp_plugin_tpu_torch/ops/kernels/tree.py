"""The overlap tree's fixed-topology passes as CUDA kernels, one launch a
level (csrc/tree.cu).

  rescan_levels   the downward volume rescan of K = 1 or 2
                  parameterizations over every level: a launch a level
                  (rescan_level)
  reduce_levels   the upward reduction, a launch a level from the deepest
                  up (reduce_level), then one launch that sums the
                  deposits onto their atoms and adds the level-1 terms
                  (deposit_atoms)

The plain twins are the torch passes of ops/tree.py (rescan_volumes,
rescan_volumes2, reduce_tree, reduce_tree2), which call these functions
(ops/tree.py::kernel_route) for CUDA float32 or float64 tensors on a
topology that carries ops/tree.py::kernel_prep, which an MD window's build
(Simulation.window_build) adds: each level's `starts` and the first
level's deposit list (`dep_order`, `dep_starts`).  Everything else keeps
the twins: the CPU, a topology without the prep (a tree built in the
call, as the scorer's, and AGBNP2's trees), the atoms mesh, AGBNP2's extra
channels.  A pass is
15 launches where the torch passes dispatch 800-1,500 operations.

Each wrapper checks its arguments, launches on the current stream, raises
if the launch failed, adds one to its count in pairs.LAUNCHES
(tree_rescan, tree_reduce, tree_deposit) and records the counter
`tree.kernel` with its site (rescan, reduce, deposit; utils/profiling.py).
There is no fallback to the twin.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import profiling
from .pairs import LAUNCHES, _check, _cuda_lib, _launch_check

LEVEL_COLS = 13   # a level's packed row (ops/tree.py _D)
ATOM_COLS = 6     # a level-1 packed row: gv, ga, gc, gamma
# the gamma's column in a parent table of each width
GAMMA_COL = {ATOM_COLS: 5, LEVEL_COLS: 11}


def channels(k: int, selfvol: bool) -> tuple[int, int]:
    """(upward channels, deposit columns) of a reduction of k
    parameterizations: the 5-channel energy family and 3 gradient columns
    each, and one self-volume column each way with selfvol."""
    return 5 * k + int(selfvol), 3 * k + int(selfvol)


def _is_double(x) -> int:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tree kernels take float32 or float64, got "
                        f"{x.dtype}")
    return int(x.dtype == torch.float64)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launched(name: str, site: str, rc: int):
    _launch_check(name, rc)
    LAUNCHES[name] += 1
    profiling.count("tree.kernel", site=site)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def rescan_level(parents, tables, bnd: dict, valid):
    """One level of the downward rescan, one launch: the packed [cap, 13]
    rows of each parameterization k (ops/tree.py::_cand_dat of its parent's
    row and its atom's row) from its parent table parents[k] (the level-1
    table [N, 6] at the first stored level, the level above's [P, 13]
    after) and its level-1 table tables[k] [N, 6], by the level's int32
    ids bnd["pmono32"] and bnd["atom32"]; invalid rows zero."""
    k = len(tables)
    if not 1 <= k <= 2 or len(parents) != k:
        raise ValueError(f"{len(parents)} parent tables for {k} level-1 "
                         "tables, expected 1 or 2 of each")
    dev = valid.device
    dtype = tables[0].dtype
    dbl = _is_double(tables[0])
    cap = valid.shape[0]
    natoms, width = tables[0].shape[0], parents[0].shape[-1]
    if width not in GAMMA_COL:
        raise ValueError(f"parent rows of {width} values, expected "
                         f"{ATOM_COLS} or {LEVEL_COLS}")
    nparents = parents[0].shape[0]
    for j in range(k):
        _check(f"tables[{j}]", tables[j], dtype, (natoms, ATOM_COLS), dev)
        _check(f"parents[{j}]", parents[j], dtype, (nparents, width), dev)
    _check("valid", valid, torch.bool, (cap,), dev)
    _check("pmono32", bnd["pmono32"], torch.int32, (cap,), dev)
    _check("atom32", bnd["atom32"], torch.int32, (cap,), dev)
    outs = [torch.empty((cap, LEVEL_COLS), dtype=dtype, device=dev)
            for _ in range(k)]
    rc = _cuda_lib().agbnp_tree_rescan(
        dbl, k, _ptrs(parents), width, GAMMA_COL[width], nparents,
        _ptrs(tables), natoms, bnd["pmono32"].data_ptr(),
        bnd["atom32"].data_ptr(), valid.data_ptr(), cap, _ptrs(outs),
        _stream(dev))
    _launched("tree_rescan", "rescan", rc)
    return outs


def rescan_levels(levels, tables):
    """The downward rescan of every level of a topology for the level-1
    tables tables[k] [N, 6]: per level, the list of the k packed [cap, 13]
    rows (rescan_level), each level's parents the rows of the level
    above."""
    prev, out = tables, []
    for lvl in levels:
        prev = rescan_level(prev, tables, lvl["bnd"], lvl["valid"])
        out.append(prev)
    return out


def reduce_level(dats, gammas, starts, acc_in, dep, volcoeffp: float,
                 selfvol: bool):
    """One level of the upward reduction, one launch.  Each parent p of
    the level above (an atom at the first stored level) takes its children,
    the rows starts[p] .. starts[p + 1] - 1 of dats[k] [cap, 13] and
    gammas[k] [cap] (any stride), adds each one's channels (volcoeffp: the
    level's cf / level) to its accumulator acc_in [cap, C] (None at the
    deepest level), writes its deposit row into dep [cap, DC] and sums its
    upward row into the parent's, in row order.  Returns the parents'
    accumulators [P, C] (C, DC: channels(k, selfvol))."""
    k = len(dats)
    if not 1 <= k <= 2 or len(gammas) != k:
        raise ValueError(f"{len(dats)} level tables and {len(gammas)} gamma "
                         "vectors, expected 1 or 2 of each")
    dev = dep.device
    dtype = dats[0].dtype
    dbl = _is_double(dats[0])
    cap = dats[0].shape[0]
    nch, ndep = channels(k, selfvol)
    for j in range(k):
        _check(f"dats[{j}]", dats[j], dtype, (cap, LEVEL_COLS), dev)
        g = gammas[j]
        if (g.device != dev or g.dtype != dtype or tuple(g.shape) != (cap,)
                or g.stride(0) < 1):
            raise ValueError(f"gammas[{j}]: {g.dtype} {tuple(g.shape)} on "
                             f"{g.device}, expected {dtype} ({cap},) on "
                             f"{dev}")
    if starts.dim() != 1 or starts.shape[0] < 2:
        raise ValueError(f"starts: shape {tuple(starts.shape)}, expected "
                         "[P + 1]")
    nparents = starts.shape[0] - 1
    _check("starts", starts, torch.int32, (nparents + 1,), dev)
    if acc_in is not None:
        _check("acc_in", acc_in, dtype, (cap, nch), dev)
    _check("dep", dep, dtype, (cap, ndep), dev)
    acc_out = torch.empty((nparents, nch), dtype=dtype, device=dev)
    gstride = (ctypes.c_int * k)(*[g.stride(0) for g in gammas])
    rc = _cuda_lib().agbnp_tree_reduce(
        dbl, k, int(selfvol), float(volcoeffp), _ptrs(dats), _ptrs(gammas),
        gstride, starts.data_ptr(), nparents,
        None if acc_in is None else acc_in.data_ptr(), acc_out.data_ptr(),
        dep.data_ptr(), _stream(dev))
    _launched("tree_reduce", "reduce", rc)
    return acc_out


def deposit_atoms(dep, order, dstarts, acc, gammas, volumes,
                  selfvol: bool):
    """The deposits on the atoms and the level-1 terms, one launch: atom i
    adds the rows dep[order[n]] for n in dstarts[i] .. dstarts[i + 1] - 1
    in that order, from zero.  Returns (dr, e_psi, self_volume): dr[k] [N,
    3] the deposits plus the accumulator's gradient channels, e_psi[k] [N]
    = gammas[k] volumes[k] + the accumulator's psi, and with selfvol the
    last parameterization's self volumes [N] (else None)."""
    k = len(gammas)
    if not 1 <= k <= 2 or len(volumes) != k:
        raise ValueError(f"{len(gammas)} gamma and {len(volumes)} volume "
                         "vectors, expected 1 or 2 of each")
    dev = dep.device
    dtype = dep.dtype
    dbl = _is_double(dep)
    natoms = dstarts.shape[0] - 1
    nch, ndep = channels(k, selfvol)
    gammas = [g.contiguous() for g in gammas]
    volumes = [v.contiguous() for v in volumes]
    _check("dep", dep, dtype, (dep.shape[0], ndep), dev)
    _check("order", order, torch.int32, (dep.shape[0],), dev)
    _check("dstarts", dstarts, torch.int32, (natoms + 1,), dev)
    _check("acc", acc, dtype, (natoms, nch), dev)
    for j in range(k):
        _check(f"gammas[{j}]", gammas[j], dtype, (natoms,), dev)
        _check(f"volumes[{j}]", volumes[j], dtype, (natoms,), dev)
    dr = [torch.empty((natoms, 3), dtype=dtype, device=dev)
          for _ in range(k)]
    e_psi = [torch.empty(natoms, dtype=dtype, device=dev) for _ in range(k)]
    sv = torch.empty(natoms, dtype=dtype, device=dev) if selfvol else None
    rc = _cuda_lib().agbnp_tree_deposit(
        dbl, k, int(selfvol), order.data_ptr(), dstarts.data_ptr(), natoms,
        dep.data_ptr(), acc.data_ptr(), _ptrs(gammas), _ptrs(volumes),
        _ptrs(dr), _ptrs(e_psi), None if sv is None else sv.data_ptr(),
        _stream(dev))
    _launched("tree_deposit", "deposit", rc)
    return dr, e_psi, sv


def reduce_levels(level_sets, level1s, selfvol: bool):
    """The upward reduction of k same-topology trees (level_sets[k]: the
    levels of parameterization k, each with its packed rows `_dat` and its
    gammas `gamma1i`; level1s[k]: its level-1 dict), one launch a level
    and one more: reduce_level from the deepest level up, then
    deposit_atoms over the first level's deposit list.  Returns
    deposit_atoms' (dr, e_psi, self_volume)."""
    k = len(level_sets)
    levels = level_sets[0]
    caps = [lvl["valid"].shape[0] for lvl in levels]
    ref = levels[0]["_dat"]
    dep = torch.empty((sum(caps), channels(k, selfvol)[1]), dtype=ref.dtype,
                      device=ref.device)
    acc, off = None, 0
    for li in range(len(levels) - 1, -1, -1):
        level_no = li + 2
        cf = -1.0 if level_no % 2 == 0 else 1.0
        acc = reduce_level([ls[li]["_dat"] for ls in level_sets],
                           [ls[li]["gamma1i"] for ls in level_sets],
                           levels[li]["bnd"]["starts"], acc,
                           dep[off:off + caps[li]], cf / level_no, selfvol)
        off += caps[li]
    bnd = levels[0]["bnd"]
    return deposit_atoms(dep, bnd["dep_order"], bnd["dep_starts"], acc,
                         [l1["gamma1i"] for l1 in level1s],
                         [l1["gv"] for l1 in level1s], selfvol)
