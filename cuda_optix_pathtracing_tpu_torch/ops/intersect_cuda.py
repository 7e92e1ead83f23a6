"""Wrappers of the brute-force intersection kernels (``csrc/intersect.cu``),
the counterpart of the reference ``ops/intersect_pallas.py``.

For CUDA tensors each wrapper launches its kernel on the current stream or
raises; for CPU tensors it runs the plain PyTorch version from
``ops/intersect.py`` (``closest_plain`` / ``any_plain`` here). There is no
fallback from a failed launch. Each launch adds 1 to the counter
``launches.<wrapper>`` (``utils/trace.py``), and nothing else does.

The kernels read the triangles as 48 B rows ``[v0, . | e0, 0 | e1, 0]``
(``rows=``: a brute-force scene's ``brute_tables[:12 * T]``, built once per
scene, or ``ops/bvh.pack_tri_rows``, which a call without ``rows`` builds)
and write the index as int64 and the flag as bool, so on the card a call
with contiguous rays and ``rows`` given is one kernel launch and nothing
else.
The launching branch is wrapped in ``ops/autodiff.nondiff_kernel`` (zero
gradient to the rays and triangles, as the reference wraps its Pallas
calls); the plain version stays differentiable through its own ops.
"""

from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from ..utils import trace
from . import _cuda_build
from .autodiff import nondiff_kernel
from .bvh import pack_tri_rows
from .intersect import intersect_any as any_plain
from .intersect import intersect_closest_raw as closest_plain
from .shade_tables import BRUTE_ROW_WORDS

# the (T, 12) float32 rows must fit one block's shared memory (227 KB)
MAX_TRIS = (227 * 1024) // (BRUTE_ROW_WORDS * 4)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _cuda_build.load("intersect")
    lib.closest_bruteforce.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P]
    lib.closest_bruteforce.restype = _I
    lib.anyhit_bruteforce.argtypes = [_P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _P, _P]
    lib.anyhit_bruteforce.restype = _I
    return lib


def _rows(v0, e0, e1, rows):
    """The kernels' rows for (v0, e0, e1), checked → (rows, T)."""
    n_tris = v0.shape[0]
    if n_tris > MAX_TRIS:
        raise ValueError(
            f"{n_tris} triangles exceed the brute-force kernels' "
            f"shared-memory table ({MAX_TRIS}); give the scene a BVH "
            "(scene_from_host(use_bvh=True)) for the traversal kernels "
            "(ops/bvh_cuda.py)"
        )
    if rows is None:
        rows = pack_tri_rows(v0.to(torch.float32), e0.to(torch.float32), e1.to(torch.float32))
    if rows.dtype != torch.float32 or rows.numel() != BRUTE_ROW_WORDS * n_tris:
        raise ValueError(
            f"rows must hold {n_tris} float32 rows of {BRUTE_ROW_WORDS} words, got "
            f"{tuple(rows.shape)} {rows.dtype}"
        )
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned (float4 loads)")
    return rows, n_tris


def _check_rays(o, d, rows):
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3) float32, got {tuple(x.shape)} {x.dtype}")
        if x.device != rows.device:
            raise ValueError(f"{name} is on {x.device}, triangles on {rows.device}")
    if o.shape[0] != d.shape[0]:
        raise ValueError("o and d differ in length")


def _t_max_arg(t_max, n: int, device):
    """(pointer, stride, value) of ``t_max``: a float32 tensor on the
    rays' device of one value (stride 0) or (N,) (its stride), read in
    place; or a Python number, passed by value."""
    if isinstance(t_max, numbers.Real):
        return None, 0, float(t_max)
    if t_max.dtype != torch.float32 or t_max.device != device:
        raise ValueError(f"t_max must be float32 on {device}, got {t_max.dtype} on {t_max.device}")
    if t_max.numel() == 1:
        return t_max.data_ptr(), 0, 0.0
    if t_max.dim() != 1 or t_max.shape[0] != n:
        raise ValueError(f"t_max must be one value or ({n},), got {tuple(t_max.shape)}")
    return t_max.data_ptr(), t_max.stride(0), 0.0


def _stream():
    return torch.cuda.current_stream().cuda_stream


def closest_bruteforce(o, d, v0, e0, e1, rows=None):
    """Closest hit of every ray → (best_t (N,) f32, best_i (N,) int64)."""
    if not o.is_cuda:
        return closest_plain(o, d, v0, e0, e1)
    return _closest_launch(o, d, v0, e0, e1, rows)


@nondiff_kernel
def _closest_launch(o, d, v0, e0, e1, rows):
    rows, n_tris = _rows(v0, e0, e1, rows)
    o, d = o.contiguous(), d.contiguous()
    _check_rays(o, d, rows)
    n = o.shape[0]
    best_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    best_i = torch.empty((n,), dtype=torch.int64, device=o.device)
    if n:
        rc = _lib().closest_bruteforce(
            o.data_ptr(), d.data_ptr(), rows.data_ptr(), n, n_tris,
            best_t.data_ptr(), best_i.data_ptr(), _stream(),
        )
        if rc:
            raise RuntimeError(f"closest_bruteforce launch failed: CUDA error {rc}")
        trace.count("launches.closest_bruteforce")
    return best_t, best_i


def anyhit_bruteforce(o, d, v0, e0, e1, t_max, rows=None):
    """Occlusion flag (N,) bool: a hit at T_MIN < t < t_max."""
    if not o.is_cuda:
        return any_plain(o, d, v0, e0, e1, t_max)
    return _any_launch(o, d, v0, e0, e1, t_max, rows)


@nondiff_kernel
def _any_launch(o, d, v0, e0, e1, t_max, rows):
    rows, n_tris = _rows(v0, e0, e1, rows)
    o, d = o.contiguous(), d.contiguous()
    _check_rays(o, d, rows)
    n = o.shape[0]
    tm_ptr, tm_stride, tm_value = _t_max_arg(t_max, n, o.device)
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    if n:
        rc = _lib().anyhit_bruteforce(
            o.data_ptr(), d.data_ptr(), tm_ptr, tm_stride, tm_value, rows.data_ptr(), n,
            n_tris, occ.data_ptr(), _stream(),
        )
        if rc:
            raise RuntimeError(f"anyhit_bruteforce launch failed: CUDA error {rc}")
        trace.count("launches.anyhit_bruteforce")
    return occ

