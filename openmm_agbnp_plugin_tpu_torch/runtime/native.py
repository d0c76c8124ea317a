"""ctypes bindings for the native f64 GaussVol overlap-tree engine.

A copy of the JAX package's runtime/native.py over the same C++ source
(runtime/gaussvol_native.cpp) and Makefile: NativeGaussVol (the overlap
tree in float64: the capacity sizing pre-pass and a fast oracle for large
systems), NativeAGBNP1 (the whole AGBNP1 evaluation in float64, an
independent ground truth for the port) and size_tree_caps (this package's
TreeCaps from one native build).

The library is built at first use with the host's make and g++ into
`_build/native-<hash>/` inside this package (listed in .gitignore), keyed
by the source, the Makefile and the host's CPU model, never into the
source directory; nothing builds at import.  available() is False where
no compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_BUILD_ROOT = _HERE.parent / "_build"
_LIB_NAME = "libgaussvol_native.so"
_LIB = None


def _cpu_model() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"model name")), b"")
    except OSError:
        return b""


def library_path() -> pathlib.Path:
    """Where the library of the current source and Makefile is built, for
    this kind of host (the Makefile compiles with -march=native, so a copy
    of the tree on another CPU builds its own)."""
    h = hashlib.sha256()
    for name in ("gaussvol_native.cpp", "Makefile"):
        h.update((_HERE / name).read_bytes())
    h.update(platform.machine().encode() + _cpu_model())
    return _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / _LIB_NAME


def build() -> pathlib.Path:
    """Build the library if it is not there yet (make -C runtime OUT=...,
    into a temporary name renamed into place, so two processes building it
    at once never load a half-written file).  Returns its path; raises if
    make fails."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["make", "-s", "-B", "-C", str(_HERE), f"OUT={tmp}"],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.gv_create.restype = ctypes.c_void_p
    lib.gv_create.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.gv_destroy.argtypes = [ctypes.c_void_p]
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.gv_compute_tree.argtypes = [ctypes.c_void_p, dptr, dptr, dptr, dptr]
    lib.gv_rescan_volumes.argtypes = [ctypes.c_void_p, dptr, dptr, dptr, dptr]
    lib.gv_rescan_gammas.argtypes = [ctypes.c_void_p, dptr]
    lib.gv_compute_volume.argtypes = [ctypes.c_void_p, dptr, dptr, dptr, dptr,
                                      dptr, dptr]
    lib.gv_level_stats.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.gv_total_nodes.restype = ctypes.c_int
    lib.gv_total_nodes.argtypes = [ctypes.c_void_p]
    lib.agbnp1_create.restype = ctypes.c_void_p
    lib.agbnp1_create.argtypes = [ctypes.c_int, dptr, dptr, dptr, dptr,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_double]
    lib.agbnp1_destroy.argtypes = [ctypes.c_void_p]
    lib.agbnp1_energy_forces.argtypes = [ctypes.c_void_p, dptr,
                                         ctypes.c_double, ctypes.c_double,
                                         dptr, dptr, dptr, dptr, dptr]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(x):
    return np.ascontiguousarray(x, dtype=np.float64)


class NativeGaussVol:
    """Fast float64 overlap-tree engine (sizing pre-pass + large-system
    oracle)."""

    def __init__(self, natoms: int, ishydrogen):
        lib = _load()
        if lib is None:
            raise RuntimeError("native gaussvol library unavailable")
        self._lib = lib
        self.natoms = natoms
        ish = np.ascontiguousarray(ishydrogen, dtype=np.int32)
        self._h = lib.gv_create(
            natoms, ish.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gv_destroy(self._h)
            self._h = None

    def compute_tree(self, pos, radii, volumes, gammas):
        pos, r, v, g = (_f64(x) for x in (pos, radii, volumes, gammas))
        self._lib.gv_compute_tree(self._h, _dp(pos), _dp(r), _dp(v), _dp(g))

    def rescan_volumes(self, pos, radii, volumes, gammas):
        pos, r, v, g = (_f64(x) for x in (pos, radii, volumes, gammas))
        self._lib.gv_rescan_volumes(self._h, _dp(pos), _dp(r), _dp(v), _dp(g))

    def rescan_gammas(self, gammas):
        g = _f64(gammas)
        self._lib.gv_rescan_gammas(self._h, _dp(g))

    def compute_volume(self):
        """Returns (energy, volume, force, dv, free_volume, self_volume)."""
        n = self.natoms
        energy = np.zeros(1)
        volume = np.zeros(1)
        dr = np.zeros((n, 3))
        dv = np.zeros(n)
        fv = np.zeros(n)
        sv = np.zeros(n)
        self._lib.gv_compute_volume(self._h, _dp(energy), _dp(volume),
                                    _dp(dr), _dp(dv), _dp(fv), _dp(sv))
        return energy[0], volume[0], -dr, dv, fv, sv

    def total_nodes(self) -> int:
        return int(self._lib.gv_total_nodes(self._h))

    def level_stats(self):
        """Returns (counts[9], max_siblings[9]) for levels 0..8."""
        counts = np.zeros(9, dtype=np.int32)
        sibs = np.zeros(9, dtype=np.int32)
        ip = ctypes.POINTER(ctypes.c_int)
        self._lib.gv_level_stats(self._h, counts.ctypes.data_as(ip),
                                 sibs.ctypes.data_as(ip))
        return counts, sibs


class NativeAGBNP1:
    """Full native AGBNP1 evaluation (f64, O(N^2) sweeps): the overlap-tree
    cavity term, I4-spline Born radii (tables built natively from the
    closed-form i4 integral), GB self/pair, vdW dispersion, the descreening
    chain and the W/U gamma-rescan force pass, sharing no code with the
    port.  Mirrors reference ReferenceAGBNPKernels.cpp:274-795."""

    def __init__(self, params):
        lib = _load()
        if lib is None:
            raise RuntimeError("native agbnp1 library unavailable")
        self._lib = lib
        self.natoms = params.n
        r, g, a, c = (_f64(x) for x in (params.radii_vdw, params.gamma,
                                        params.alpha, params.charge))
        ish = np.ascontiguousarray(params.ishydrogen, np.int32)
        self._keep = (r, g, a, c, ish)
        self._h = lib.agbnp1_create(
            params.n, _dp(r), _dp(g), _dp(a), _dp(c),
            ish.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            float(params.roffset))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.agbnp1_destroy(self._h)
            self._h = None

    def energy_forces(self, pos, cutoff=None, horizon=None):
        """Returns dict(energy, force [N, 3], born_radius, self_volume,
        e_cav, gb_self, gb_pair, e_vdw).  cutoff None = NoCutoff GB;
        horizon None = the 2 nm LUT descreening horizon ("cutoff" mode
        passes the cutoff value)."""
        n = self.natoms
        pos = _f64(pos)
        energy = np.zeros(1)
        force = np.zeros((n, 3))
        born = np.zeros(n)
        sv = np.zeros(n)
        comp = np.zeros(4)
        self._lib.agbnp1_energy_forces(
            self._h, _dp(pos), float(cutoff or 0.0), float(horizon or 0.0),
            _dp(energy), _dp(force), _dp(born), _dp(sv), _dp(comp))
        return dict(energy=energy[0], force=force, born_radius=born,
                    self_volume=sv, e_cav=comp[0], gb_self=comp[1],
                    gb_pair=comp[2], e_vdw=comp[3])


def size_tree_caps(params, pos, boost: float = 1.6, align: int = 128):
    """Capacity sizing pre-pass: build the tree natively at large radii and
    derive this package's per-level TreeCaps (capacities and sibling
    windows) with headroom (the tree_size_boost analogue, reference
    OpenCLAGBNPKernels.h:145)."""
    from ..models.constants import sphere_volume
    from ..ops.tree import TreeCaps

    gv = NativeGaussVol(params.n, params.ishydrogen)
    radii = np.asarray(params.radii_large)
    volumes = np.where(np.asarray(params.ishydrogen) > 0, 0.0,
                       sphere_volume(radii))
    gv.compute_tree(pos, radii, volumes,
                    np.asarray(params.gamma) / params.roffset)
    counts, sibs = gv.level_stats()

    def r(x):
        return max(align, int(np.ceil(x / align)) * align)

    caps = tuple(r(counts[k] * boost) for k in range(2, 9))
    # offs[l] is the sibling window used to pair level-(l+2) nodes; it must
    # cover the largest sibling group at that level (minus one), with at
    # least 1.6x headroom: equilibrium sibling-group maxima fluctuate
    # proportionally more than level counts on small systems
    offs_boost = max(boost, 1.6)
    offs = tuple(int(max(4, np.ceil(max(sibs[k] - 1, 1) * offs_boost)))
                 for k in range(2, 8))
    return TreeCaps(caps=caps, offs=offs)
