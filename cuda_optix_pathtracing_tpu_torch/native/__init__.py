"""Host-side C++ of the port, reached over ctypes: the BVH builder
(``native/src/bvh_build.cpp``) and the mesh attributes of scene files,
smooth normals and affine transforms of triangle soups
(``native/src/mesh.cpp``).

The library is compiled with ``g++`` at first use into the package's
``_build/`` directory, named by a hash of the sources, the flags and the
host CPU, so an edited source rebuilds and an unchanged one loads at once.
The flags are the reference's (``-O3 -march=native``), so both packages
build the same tree and the same world-space triangles; ``-march=native``
ties the library to the CPU that built it, so a ``_build/`` copied to
another host rebuilds there. There is no numpy fallback: a binned-SAH
build in Python takes tens of seconds for a mesh scene, so a missing
``g++`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRCS = tuple(Path(__file__).resolve().parent / "src" / n for n in ("bvh_build.cpp", "mesh.cpp"))
BUILD = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()


@functools.cache
def cpu_fingerprint() -> str:
    """The machine type and, on Linux, the first CPU's model name and
    feature flags: what ``-march=native`` compiles for."""
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    lines.append(line.strip())
                elif not line.strip():
                    break  # the first CPU's block ends
    except OSError:
        pass
    return "\n".join(lines)


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + cpu_fingerprint().encode())
    for src in SRCS:
        h.update(src.read_bytes())
    return BUILD / f"native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if its cached copy is missing → its path."""
    out = lib_path()
    with _lock:
        if out.exists():
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                "g++ not found: the port's host library (native/src/*.cpp) is "
                "compiled at first use"
            )
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        r = subprocess.run(
            [gxx, *GXX_FLAGS, "-o", str(tmp), *map(str, SRCS)],
            capture_output=True, text=True, timeout=300,
        )
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for native/src:\n{r.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.dtpt_bvh_build.restype = ctypes.c_void_p
    lib.dtpt_bvh_build.argtypes = [
        f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dtpt_bvh_copy.restype = None
    lib.dtpt_bvh_copy.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p, i32p]
    lib.dtpt_bvh_free.restype = None
    lib.dtpt_bvh_free.argtypes = [ctypes.c_void_p]
    lib.dtpt_smooth_normals.restype = None
    lib.dtpt_smooth_normals.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, f32p]
    lib.dtpt_transform_tris.restype = None
    lib.dtpt_transform_tris.argtypes = [f32p, ctypes.c_int64, f32p, f32p]
    return lib


def bvh_build_native(v0, e0, e1, leaf_size: int, n_bins: int):
    """Binned-SAH 8-wide build of (T, 3) float32 triangles → numpy
    (child_lo, child_hi, child_node, leaf_start, leaf_count, tri_order) in
    the ``ops/bvh.py`` BVHArrays layout."""
    lib = _lib()
    v0 = np.ascontiguousarray(v0, np.float32)
    e0 = np.ascontiguousarray(e0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    t = v0.shape[0]
    if t == 0:
        raise ValueError("a BVH needs at least one triangle")
    n_nodes = ctypes.c_int64(0)
    h = lib.dtpt_bvh_build(v0, e0, e1, t, leaf_size, n_bins, ctypes.byref(n_nodes))
    m = n_nodes.value
    child_lo = np.empty((m, 8, 3), np.float32)
    child_hi = np.empty((m, 8, 3), np.float32)
    child_node = np.empty((m, 8), np.int32)
    leaf_start = np.empty((m, 8), np.int32)
    leaf_count = np.empty((m, 8), np.int32)
    tri_order = np.empty((t,), np.int32)
    try:
        lib.dtpt_bvh_copy(h, child_lo, child_hi, child_node, leaf_start, leaf_count, tri_order)
    finally:
        lib.dtpt_bvh_free(h)
    return child_lo, child_hi, child_node, leaf_start, leaf_count, tri_order


def smooth_normals(tris, crease_deg: float = 66.0) -> np.ndarray:
    """Per-corner smooth shading normals of a (T,3,3) triangle soup: weld
    identical positions, average area-weighted face normals per vertex,
    per corner only over faces within the crease angle of its own."""
    tris = np.ascontiguousarray(tris, np.float32)
    out = np.empty_like(tris)
    if tris.shape[0]:
        _lib().dtpt_smooth_normals(tris, tris.shape[0], float(crease_deg), out)
    return out


def transform_tris(tris, m) -> np.ndarray:
    """A (T,3,3) triangle soup under a (4,4) affine matrix, in float32."""
    tris = np.ascontiguousarray(tris, np.float32)
    m = np.ascontiguousarray(m, np.float32)
    out = np.empty_like(tris)
    if tris.shape[0]:
        _lib().dtpt_transform_tris(tris, tris.shape[0], m, out)
    return out
