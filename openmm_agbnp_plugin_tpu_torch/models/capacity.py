"""The PanicButton contract (reference OpenCLAGBNPKernels.cpp:340-343,
3598-3634): each static capacity has a channel, a count measured on the
device against it.  Here: the counts layouts (AGBNP1's: the tree's 7 level
counts, then the in-range Born and GB tile counts on tile lists; AGBNP2's
18 entries, V2), a window's diagnostics and their one host read
(WindowDiag), the channels ({channel: (seen, cap)}) and every grow rule,
through grow_past: the Simulation's (regrow_v1), JAX's AGBNP2 rule
(regrow_v2), the models' (grow_tree, widened, grow_tiles), the sizing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import tree as T
from ..utils import profiling

LEVELS = 7


def grow_past(seen: int, factor: float, align: int, floor: int = 0) -> int:
    """The least multiple of align >= seen x factor, at least floor."""
    return max(floor, int(np.ceil(seen * factor / align)) * align)


def kmax_for(seen: int) -> int:
    """A list width sized from the most neighbors seen."""
    return grow_past(seen, 1.5, 16)


def widened(cap: int, seen: int, align: int = 16) -> int:
    """cap, or past 1.5 x seen where seen overflowed it: the list widths
    (align 16), cap_ms (128) and the tile budgets (8)."""
    return grow_past(seen, 1.5, align, align) if seen > cap else cap


def _regrown(cap: int, seen: int, grown: int) -> int:
    # a truncated level hides its children, so measured counts
    # underestimate deeper levels: an overflowed capacity at least doubles
    return max(2 * cap if seen > cap else cap, grown)


def v1_counts(tree_counts, tile_counts=None):
    """AGBNP1's counts vector."""
    if tile_counts is None:
        return tree_counts.long()
    return torch.cat([tree_counts.long(), tile_counts.long()], dim=-1)


def levels(counts):
    return counts[..., :LEVELS]


def tiles(counts):
    """[..., 2], or [..., 0] without tile lists."""
    return counts[..., LEVELS:LEVELS + 2]


class V2:
    """Entries of AGBNP2's 18-entry vector (JAX md/simulation.py's
    countsvec)."""
    TREE = slice(0, LEVELS)
    MS_TREE = slice(LEVELS, 2 * LEVELS)
    MS_COUNT, MS_TREE_KMAX = 14, 15
    MS_CANDIDATE_KMAX, MS_SUBTRACTION_K = 16, 17


def v2_counts(diags, cand_nb):
    """The 18-entry vector ([B, 18] for replicas) of agbnp2_energy's
    (diag, ms_diag) and the MS candidate lists' widest row."""
    d0, d1 = diags
    return torch.cat([d0["counts"].long(), d1["counts"].long(),
                      torch.stack([d1["ms_count"], d1["ms_nbmax"], cand_nb,
                                   d1["ms_sub_max"]], dim=-1).long()],
                     dim=-1)


def _max(a, b):
    if a is None or b is None:
        return b if a is None else a
    if isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    return np.maximum(a, b)


class WindowDiag(NamedTuple):
    """A rebuild window's diagnostics (a leading replica axis on each for
    replicas; shake None without constraints), on the device or read."""
    counts: object
    neighbor_max: object
    sibling_max: object
    wu_counts: object
    shake: object = None

    @classmethod
    def quiet(cls, counts, shake=None):
        """Steps without a build: zero neighbor, sibling and WU entries."""
        z = torch.zeros(counts.shape[:-1] + (LEVELS,), dtype=torch.int64,
                        device=counts.device)
        return cls(counts, z[..., 0], z, z, shake)

    def merge(self, other) -> "WindowDiag":
        """Elementwise maxima, None standing for absent; device counts of
        two lengths (a build's and its steps') zero-pad the shorter."""
        other = WindowDiag(*other)
        a, b = self.counts, other.counts
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            n = max(a.shape[-1], b.shape[-1])
            a, b = (torch.nn.functional.pad(x.long(), (0, n - x.shape[-1]))
                    for x in (a, b))
        return WindowDiag(*map(_max, (a, *self[1:]), (b, *other[1:])))

    def read(self, site: str) -> "WindowDiag":
        """On the host, in an md.host_read span: the integer channels and
        the SHAKE residual packed into one vector and read at once (one
        host_read at site), the residual carried as the bits of its
        float64 value (on the host a float64 of the same value)."""
        ints = [x for x in self[:4] if isinstance(x, torch.Tensor)]
        shake = self.shake
        if isinstance(shake, torch.Tensor):
            # its float64 bits ride the integer vector: no second read
            ints.append(shake.to(torch.float64).view(torch.int64))
        elif shake is not None:
            shake = np.asarray(shake)
        if not ints:
            return WindowDiag(*(None if x is None else np.asarray(x)
                                for x in self))
        with profiling.span("md.host_read"):
            dev = ints[0].device
            flat = profiling.host_read(torch.cat(
                [x.reshape(-1).to(dev, torch.int64) for x in ints]), site)
            parts = iter(np.split(
                flat, np.cumsum([x.numel() for x in ints])[:-1]))
            out = [next(parts).reshape(x.shape)
                   if isinstance(x, torch.Tensor)
                   else None if x is None else np.asarray(x)
                   for x in self[:4]]
            if isinstance(self.shake, torch.Tensor):
                shake = next(parts).view(np.float64).reshape(
                    self.shake.shape)
        return WindowDiag(*out, shake)

    def worst(self) -> "WindowDiag":
        """Host diagnostics of replicas reduced to the worst replica."""
        return WindowDiag(*(None if x is None else np.max(x, axis=0)
                            for x in self))


class V1Caps(NamedTuple):
    """AGBNP1's (and GVolSA's) capacities: kmax 0 without a neighbor list,
    wu None without WU compaction, tiles (born, gb or None) None without
    tile lists."""
    tree: T.TreeCaps
    kmax: int
    wu: tuple | None = None
    tiles: tuple | None = None


def _report(items) -> dict:
    return {n: (int(k), int(c)) for n, k, c in items if int(k) > int(c)}


def _levels(name: str, seen, caps) -> list:
    return [(f"{name}{i + 1}", k, c)
            for i, (k, c) in enumerate(zip(seen, caps))]


def v1_channels(diag: WindowDiag, caps: V1Caps) -> dict:
    """The overflowed channels of host diagnostics, {channel: (seen,
    cap)}: tree_level*, sibling_window*, neighbor_kmax (a cell-grid
    overflow reads kmax + 1), wu_compact_level*, tile_list_born,
    tile_list_gb."""
    items = _levels("tree_level", levels(diag.counts), caps.tree.caps)
    if diag.sibling_max is not None:
        # the deepest level's sibling groups are never enumerated further
        # (MAX_ORDER truncation, reference gaussvol.cpp:211)
        items += _levels("sibling_window", np.asarray(diag.sibling_max) - 1,
                         caps.tree.offs)
    if diag.neighbor_max is not None:
        items.append(("neighbor_kmax", diag.neighbor_max, caps.kmax))
    if diag.wu_counts is not None and caps.wu is not None:
        # kept rows past a compact cap were cut out of the WU force pass
        items += _levels("wu_compact_level", diag.wu_counts, caps.wu)
    if caps.tiles is not None:
        items += [x for x in zip(("tile_list_born", "tile_list_gb"),
                                 tiles(diag.counts), caps.tiles)
                  if x[2] is not None]
    return _report(items)


def v2_channels(c, m2, ms_kmax_list: int) -> dict:
    """The overflowed channels of an 18-entry host vector against an
    AGBNP2Model's capacities and the MS candidate lists' width (JAX
    md/simulation.py::_check_overflow_v2)."""
    return _report(
        _levels("tree_level", c[V2.TREE], m2.caps.caps)
        + _levels("ms_tree_level", c[V2.MS_TREE], m2.caps_ms.caps)
        + [("ms_count", c[V2.MS_COUNT], m2.cap_ms),
           ("ms_tree_kmax", c[V2.MS_TREE_KMAX], m2.ms_kmax),
           ("ms_candidate_kmax", c[V2.MS_CANDIDATE_KMAX], ms_kmax_list),
           ("ms_subtraction_k", c[V2.MS_SUBTRACTION_K], m2.ms_sub_k)])


def grow_tiles(budgets, seen):
    """Tile budgets widened past the in-range counts seen [born, gb]."""
    if budgets is None or seen is None or not len(seen):
        return budgets
    lb, lg = budgets
    return (widened(lb, int(seen[0]), 8),
            lg if lg is None else widened(lg, int(seen[1]), 8))


def _regrown_tree(old, seen, headroom: float, sibs=None) -> T.TreeCaps:
    caps = tuple(_regrown(c0, int(k), grow_past(int(k), headroom, 128, 128))
                 for c0, k in zip(old.caps, seen))
    offs = old.offs if sibs is None else tuple(
        _regrown(o0, int(sb) - 1, grow_past(max(int(sb) - 1, 1), headroom, 1))
        for o0, sb in zip(old.offs, sibs))
    return T.TreeCaps(caps=caps, offs=offs)


def regrow_v1(diag: WindowDiag, caps: V1Caps,
              headroom: float = 1.3) -> V1Caps:
    """The Simulation's resize (JAX md/simulation.py::_regrow): levels,
    sibling windows and WU rows past their host counts x headroom, each at
    least doubling where it overflowed; neighbor width and tiles widened."""
    wu = caps.wu
    if diag.wu_counts is not None and wu is not None:
        wu = tuple(_regrown(o, int(k), grow_past(int(k), headroom, 8, 8))
                   for o, k in zip(wu, diag.wu_counts))
    return V1Caps(_regrown_tree(caps.tree, levels(diag.counts), headroom,
                                diag.sibling_max),
                  widened(caps.kmax, int(diag.neighbor_max)), wu,
                  grow_tiles(caps.tiles, tiles(diag.counts)))


def regrow_v2(c, m2, ms_kmax_list: int, headroom: float = 1.3) -> dict:
    """JAX's AGBNP2 resize (its Simulation's and scorer's _regrow_v2) over
    an 18-entry host vector: both trees' levels as regrow_v1's, cap_ms and
    the widths widened.  Returns AGBNP2Model's caps and ms_kmax_list."""
    def width(cap, entry, align=16):
        return widened(cap, int(c[entry]), align)

    return dict(caps=_regrown_tree(m2.caps, c[V2.TREE], headroom),
                caps_ms=_regrown_tree(m2.caps_ms, c[V2.MS_TREE], headroom),
                cap_ms=width(m2.cap_ms, V2.MS_COUNT, 128),
                ms_kmax=width(m2.ms_kmax, V2.MS_TREE_KMAX),
                ms_sub_k=width(m2.ms_sub_k, V2.MS_SUBTRACTION_K),
                ms_kmax_list=width(ms_kmax_list, V2.MS_CANDIDATE_KMAX))


def grow_tree(tree: T.TreeCaps, diag) -> T.TreeCaps:
    """The models' tree rule (JAX ops/tree.py::TreeCaps.grow): overflowed
    levels and sibling windows of a build's diag double."""
    ov = T.check_overflow(diag)
    return tree.grow(ov["cap_overflow"], ov["sib_overflow"][:-1])


def size_tree(counts, sibs, boost: float) -> T.TreeCaps:
    """Capacities from a clean build's host counts (JAX size_tree_caps):
    levels x boost; sibling windows (largest group - 1) x max(boost, 1.6),
    at least 4, as sibling maxima fluctuate more than level counts."""
    return T.TreeCaps(
        caps=tuple(grow_past(int(c), boost, 128, 128) for c in counts),
        offs=tuple(grow_past(max(int(s) - 1, 1), max(boost, 1.6), 1, 4)
                   for s in sibs[:-1]))
