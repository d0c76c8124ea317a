"""CHARMM/NAMD-style DCD trajectory writer/reader (a numpy copy of the JAX
package's io/dcd.py: the same bytes for the same frames).

The reference plugin relies on OpenMM's app layer for trajectory output
(its benchmark scripts write only final coordinates back into the .dms
file, reference example/trpcage_benchmark.py:36-43); a user switching to
this framework still needs standard trajectory files for VMD / mdtraj /
MDAnalysis.  This module writes the plain single-precision DCD flavor
those tools read: Fortran unformatted records, 'CORD' header with the
CHARMM icntrl block, coordinates in Angstrom as three float32 records
(X, Y, Z) per frame, and — when a periodic box is given — the NAMD
orthorhombic unit-cell record [a, cos(gamma), b, cos(beta), cos(alpha),
c] before each frame.

Internal units are nm (converted on write/read).  `read_dcd` exists for
round-trip validation and lightweight analysis without external deps.
"""

from __future__ import annotations

import struct

import numpy as np

# CHARMM's AKMA time unit in ps: DCD headers store the timestep in AKMA
_AKMA_PS = 0.04888821

_NM_TO_ANG = 10.0


def _record(payload: bytes) -> bytes:
    n = struct.pack("<i", len(payload))
    return n + payload + n


def write_dcd(path, frames, dt_ps: float = 0.001, first_step: int = 0,
              interval: int = 1, box=None, title: str = ""):
    """Write frames [F, N, 3] (nm) as a DCD file at `path`.

    box: optional orthorhombic box lengths [3] in nm (written with every
    frame, NAMD cosine convention); dt_ps/first_step/interval fill the
    icntrl header fields readers use to reconstruct frame times.
    """
    frames = np.asarray(frames, dtype=np.float64)
    if frames.ndim == 2:
        frames = frames[None]
    F, N, _ = frames.shape
    icntrl = [0] * 20
    icntrl[0] = F                      # NSET: frames in file
    icntrl[1] = first_step             # ISTART
    icntrl[2] = interval               # NSAVC: steps between frames
    icntrl[3] = F * interval           # NSTEP
    icntrl[9] = struct.unpack("<i", struct.pack(
        "<f", dt_ps / _AKMA_PS))[0]    # DELTA as float32 bit pattern
    icntrl[10] = 1 if box is not None else 0   # unit-cell records present
    icntrl[19] = 24                    # CHARMM version tag
    hdr = b"CORD" + struct.pack("<20i", *icntrl)

    text = (title or "written by openmm_agbnp_plugin_tpu")[:80]
    tline = text.ljust(80).encode()
    titles = struct.pack("<i", 1) + tline

    with open(path, "wb") as fh:
        fh.write(_record(hdr))
        fh.write(_record(titles))
        fh.write(_record(struct.pack("<i", N)))
        cell = None
        if box is not None:
            a, b, c = (float(x) * _NM_TO_ANG for x in np.asarray(box))
            cell = _record(struct.pack("<6d", a, 0.0, b, 0.0, 0.0, c))
        for f in range(F):
            xyz = frames[f] * _NM_TO_ANG
            if cell is not None:
                fh.write(cell)
            for k in range(3):
                fh.write(_record(xyz[:, k].astype("<f4").tobytes()))


def _read_record(fh):
    raw = fh.read(4)
    if len(raw) < 4:
        return None
    (n,) = struct.unpack("<i", raw)
    payload = fh.read(n)
    fh.read(4)
    return payload


def read_dcd(path):
    """Read a DCD written by `write_dcd` (or NAMD/CHARMM orthorhombic).

    Returns (frames [F, N, 3] nm, info dict with first_step, interval,
    dt_ps, box [F, 3] nm or None).
    """
    with open(path, "rb") as fh:
        hdr = _read_record(fh)
        if hdr is None or hdr[:4] != b"CORD":
            raise ValueError("not a DCD file")
        icntrl = struct.unpack("<20i", hdr[4:84])
        _read_record(fh)  # titles
        (natoms,) = struct.unpack("<i", _read_record(fh))
        has_cell = bool(icntrl[10])
        frames, boxes = [], []
        while True:
            if has_cell:
                cell = _read_record(fh)
                if cell is None:
                    break
                a, _, b, _, _, c = struct.unpack("<6d", cell)
                boxes.append([a, b, c])
                x = _read_record(fh)
            else:
                x = _read_record(fh)
                if x is None:
                    break
            y = _read_record(fh)
            z = _read_record(fh)
            if x is None or y is None or z is None:
                break
            frames.append(np.stack([np.frombuffer(x, "<f4"),
                                    np.frombuffer(y, "<f4"),
                                    np.frombuffer(z, "<f4")], axis=1))
        frames = np.asarray(frames, dtype=np.float64) / _NM_TO_ANG
        if frames.size and frames.shape[1] != natoms:
            raise ValueError("frame size does not match header natoms")
        dt_ps = struct.unpack("<f", struct.pack("<i", icntrl[9]))[0] * _AKMA_PS
        info = dict(first_step=icntrl[1], interval=icntrl[2], dt_ps=dt_ps,
                    box=(np.asarray(boxes) / _NM_TO_ANG) if boxes else None)
        return frames, info
