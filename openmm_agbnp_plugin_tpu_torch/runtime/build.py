"""Build the CUDA sources in csrc/ at first use and load them with ctypes.

The sources have a plain C interface and include no PyTorch headers, so one
`nvcc` call builds them in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/libagbnp_pairs.so csrc/*.cu

The library lands in `_build/<hash>/` inside this package (listed in
.gitignore), keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one is reused.  Nothing here runs at import time.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument types of every exported function (pointers and the stream as
# c_void_p so 64-bit addresses are never cut)
SIGNATURES = {
    "agbnp_born_sums": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I,
                        _F, _I, _P, _P, _P, _P, _P),
    "agbnp_gb_pair": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _F, _F,
                      _P, _P, _P, _P, _P),
    "agbnp_descreen_chunks": (_I,),
    "agbnp_descreening": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                          _P, _P, _P, _P),
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
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[pathlib.Path, str]:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns (library path, compiler output; empty when reused)."""
    out = library_path()
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the pair-sweep library, with argtypes and
    restype declared for every exported function."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
