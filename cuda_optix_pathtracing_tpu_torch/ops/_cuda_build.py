"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, goes to ``_build/`` inside the package and is cached by a hash
of the source, the headers and the flags, so an edited source rebuilds and
an unchanged one loads at once. ``build_all`` starts one ``nvcc`` per
source together, so a cold start costs the slowest build, not their sum.

No ``--use_fast_math``: the intersection code relies on IEEE division
(``MT_TOLERANCE`` parallel test, ``1/where(parallel, 1, det)``) and the
shading code on accurate ``acosf``/``sinf`` and denormals.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA toolkit is "
        "needed to build the kernels in csrc/"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD / f"{name}-{_digest(name)}.so"


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the cached build of ``name``
    (registers, shared memory and spills per kernel)."""
    log = lib_path(name).with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


def _start(name: str):
    out = lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)


def build_all(names) -> None:
    """Compile every source of ``names`` that is not cached yet, with all
    ``nvcc`` processes running at once."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(lib_path(name)))
                _loaded[name] = lib
    return lib
