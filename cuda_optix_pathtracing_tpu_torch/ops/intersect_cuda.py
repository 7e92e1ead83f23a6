"""Wrappers of the brute-force intersection kernels (``csrc/intersect.cu``),
the counterpart of the reference ``ops/intersect_pallas.py``.

For CUDA tensors each wrapper launches its kernel on the current stream or
raises; for CPU tensors it runs the plain PyTorch version from
``ops/intersect.py`` (``closest_plain`` / ``any_plain`` here). There is no
fallback from a failed launch. ``launches`` on each wrapper counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda_build
from .intersect import intersect_any as any_plain
from .intersect import intersect_closest_raw as closest_plain

# (T, 9) float32 triangle rows must fit one block's shared memory
MAX_TRIS = (227 * 1024) // (9 * 4)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _cuda_build.load("intersect")
    lib.closest_bruteforce.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P]
    lib.closest_bruteforce.restype = _I
    lib.anyhit_bruteforce.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P]
    lib.anyhit_bruteforce.restype = _I
    return lib


def tri_table(v0, e0, e1):
    """(T, 9) contiguous float32 rows [v0 | e0 | e1], the kernels' layout."""
    return torch.cat([v0, e0, e1], dim=1).to(torch.float32).contiguous()


def _check_rays(o, d, tri):
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3) float32, got {tuple(x.shape)} {x.dtype}")
        if x.device != tri.device:
            raise ValueError(f"{name} is on {x.device}, triangles on {tri.device}")
    if o.shape[0] != d.shape[0]:
        raise ValueError("o and d differ in length")
    if tri.shape[0] > MAX_TRIS:
        raise ValueError(
            f"{tri.shape[0]} triangles exceed the brute-force kernels' "
            f"shared-memory table ({MAX_TRIS}); give the scene a BVH "
            "(scene_from_host(use_bvh=True)) for the traversal kernels "
            "(ops/bvh_cuda.py)"
        )


def _stream():
    return torch.cuda.current_stream().cuda_stream


def closest_bruteforce(o, d, v0, e0, e1):
    """Closest hit of every ray → (best_t (N,) f32, best_i (N,) int64)."""
    if not o.is_cuda:
        return closest_plain(o, d, v0, e0, e1)
    tri = tri_table(v0, e0, e1)
    o, d = o.contiguous(), d.contiguous()
    _check_rays(o, d, tri)
    n = o.shape[0]
    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    best_i = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n:
        rc = _lib().closest_bruteforce(
            o.data_ptr(), d.data_ptr(), tri.data_ptr(), n, tri.shape[0],
            best_t.data_ptr(), best_i.data_ptr(), _stream(),
        )
        if rc:
            raise RuntimeError(f"closest_bruteforce launch failed: CUDA error {rc}")
        closest_bruteforce.launches += 1
    return best_t, best_i.to(torch.int64)


closest_bruteforce.launches = 0


def anyhit_bruteforce(o, d, v0, e0, e1, t_max):
    """Occlusion flag (N,) bool: a hit at T_MIN < t < t_max."""
    if not o.is_cuda:
        return any_plain(o, d, v0, e0, e1, t_max)
    tri = tri_table(v0, e0, e1)
    o, d = o.contiguous(), d.contiguous()
    _check_rays(o, d, tri)
    n = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = torch.broadcast_to(t_max, (n,)).contiguous()
    occ = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n:
        rc = _lib().anyhit_bruteforce(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), tri.data_ptr(), n,
            tri.shape[0], occ.data_ptr(), _stream(),
        )
        if rc:
            raise RuntimeError(f"anyhit_bruteforce launch failed: CUDA error {rc}")
        anyhit_bruteforce.launches += 1
    return occ > 0


anyhit_bruteforce.launches = 0
