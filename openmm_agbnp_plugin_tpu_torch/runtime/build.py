"""Build the CUDA sources in csrc/ at first use and load them with ctypes.

The sources have a plain C interface and include no PyTorch headers.  Each
`.cu` file compiles to an object in its own `nvcc` process, all started
together, and one more `nvcc` call links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <build dir>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o <build dir>/libagbnp_pairs.so <build dir>/*.o

The library lands in `_build/<hash>/` inside this package (listed in
.gitignore), keyed by a hash of the sources, headers and flags, so a changed
source rebuilds and an unchanged one is reused.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libagbnp_pairs.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

# argument types of every exported function (pointers and the stream as
# c_void_p so 64-bit addresses are never cut); the pair sweeps take the
# replica count first (the GB sweep then whether its list is shared)
SIGNATURES = {
    "agbnp_subtile_columns": (_I, _P, _I, _P, _I, _P, _I, _F, _I, _P, _P, _P,
                              _P, _P),
    "agbnp_born_sums": (_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I,
                        _F, _I, _P, _F, _I, _P, _P, _P, _I, _P, _P, _P, _P),
    "agbnp_empty_launch": (_P,),
    "agbnp_descreening": (_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                          _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P),
    "agbnp_born_sums_tiles": (_I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P,
                              _P, _P, _P, _I, _I, _P, _I, _F, _I, _P, _P, _P,
                              _P, _P, _P, _P),
    "agbnp_gb_pair_tiles": (_I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                            _P, _I, _I, _F, _F, _I, _P, _F, _F, _P, _P, _P, _P,
                            _P, _P, _P, _P),
    "agbnp_descreening_tiles": (_I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P,
                                _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P,
                                _P),
    "agbnp_take_rows": (_P, _I, _I, _P, _I, _P, _P),
    "agbnp_cumsum_tile_rows": (_I,),
    "agbnp_cumsum_state_ints": (_I, _I),
    "agbnp_cumsum_rows": (_P, _I, _I, _P, _P, _P, _P),
    "agbnp_tree_rescan": (_I, _I, _P, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P,
                          _P),
    "agbnp_tree_reduce": (_I, _I, _I, _D, _P, _P, _P, _P, _I, _P, _P, _P, _P),
    "agbnp_tree_deposit": (_I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _check(proc, cmd, out):
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, in parallel, then a link.  Returns (library path,
    compiler output; empty when reused)."""
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        # nvcc picks the input type from the extension: keep ".o" last
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(text)
        _check(proc, cmd, text)
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
           *(str(o) for _, o, _ in jobs)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    log.append(proc.stdout)
    _check(proc, cmd, proc.stdout)
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, out)
    return out, "".join(log)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes and
    restype declared for every exported function."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
