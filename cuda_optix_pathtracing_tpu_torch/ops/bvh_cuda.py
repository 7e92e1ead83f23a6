"""Wrappers of the BVH traversal kernels (``csrc/bvh.cu``), the
counterpart of the reference ``ops/bvh_pallas.py``.

``bvh_closest_raw`` and ``bvh_any_raw`` take the rays and one mesh's
tables: a BVH scene's own, or an instance's base mesh
(``scene/types.MeshTables``, whose fields a Scene shares). The kernels
walk its compact tables (``bvh.nodes``, 256 B nodes, and ``tri_rows``,
``(Tp, 12)`` rows in packed-BVH order), built once per scene, as the
fused kernels do, and return rows local to that mesh. Nothing is packed
per launch. For
CUDA tensors each wrapper launches its kernel or raises; for CPU tensors
it runs the plain version, the brute-force sweep over the same packed,
padded arrays (``ops/intersect.py``), which is what the reference computes
for BVH scenes off the TPU. Pad rows have zero edges and never hit. The
kernel may pick another row than the sweep where two triangles tie in t.
Each launch adds 1 to the counter ``launches.<wrapper>``
(``utils/trace.py``), and nothing else does.
The launching branch is wrapped in ``ops/autodiff.nondiff_kernel`` (zero
gradient to the rays and ``t_max``); the plain version stays
differentiable through its own ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import trace
from . import _cuda_build
from .autodiff import nondiff_kernel
from .bvh import COMPACT_STACK, stack_fits
from .intersect import intersect_any, intersect_closest_raw

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _cuda_build.load("bvh")
    lib.bvh_closest.argtypes = [_P] * 4 + [_I] + [_P] * 3
    lib.bvh_closest.restype = _I
    lib.bvh_anyhit.argtypes = [_P] * 5 + [_I] + [_P] * 2
    lib.bvh_anyhit.restype = _I
    return lib


def check_bvh_scene(scene, o, d) -> None:
    """Raise unless ``scene`` (a Scene or one mesh's MeshTables) has a BVH
    the kernels can walk (its depth fits their stack, its compact tables
    (a Scene's material ids too, which the fused kernels read) are
    contiguous and its node indices fit a stack entry's 24 bits) and the
    rays are (N, 3) float32 on its device. Both kernel families walk the
    same tables (``csrc/bvh_compact.cuh``): the traversal kernels here and
    the fused BVH kernels (``models/megakernel_cuda.py``)."""
    bvh = scene.bvh
    if bvh is None:
        raise ValueError("the scene has no BVH")
    if not stack_fits(bvh.depth):
        raise ValueError(
            f"BVH depth {bvh.depth} needs {bvh.depth - 1} entries of the kernels' compact "
            f"stack (one per level above the deepest; it has {COMPACT_STACK})"
        )
    if bvh.nodes.shape[0] >= 1 << 24:  # a stack entry holds the node in 24 bits
        raise ValueError(f"{bvh.nodes.shape[0]} BVH nodes, more than the kernels' 2^24")
    for name, x in (("o", o), ("d", d)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3) float32, got {tuple(x.shape)} {x.dtype}")
        if x.device != scene.tri_v0.device:
            raise ValueError(f"{name} is on {x.device}, the scene on {scene.tri_v0.device}")
    if o.shape[0] != d.shape[0]:
        raise ValueError("o and d differ in length")
    tables = (bvh.nodes, scene.tri_rows, getattr(scene, "tri_mat", bvh.nodes))
    if not all(x.is_contiguous() for x in tables):
        raise ValueError("the scene's compact BVH tables must be contiguous")


def _tables(scene):
    return scene.bvh.nodes.data_ptr(), scene.tri_rows.data_ptr()


def bvh_closest_raw(o, d, scene):
    """Closest hit of every ray on the mesh ``scene`` → (t (N,) f32,
    packed row (N,) int64), BIG_T and row 0 on a miss."""
    if not o.is_cuda:
        return intersect_closest_raw(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1)
    return _closest_launch(o, d, scene)


@nondiff_kernel
def _closest_launch(o, d, scene):
    o, d = o.contiguous(), d.contiguous()
    check_bvh_scene(scene, o, d)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    i = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n:
        rc = _lib().bvh_closest(
            o.data_ptr(), d.data_ptr(), *_tables(scene), n, t.data_ptr(), i.data_ptr(),
            torch.cuda.current_stream(o.device).cuda_stream,
        )
        if rc:
            raise RuntimeError(f"bvh_closest launch failed: CUDA error {rc}")
        trace.count("launches.bvh_closest_raw")
    return t, i.to(torch.int64)


def bvh_any_raw(o, d, scene, t_max):
    """Occlusion flags (N,) int32: 1 where a triangle is hit at
    T_MIN < t < t_max."""
    if not o.is_cuda:
        return intersect_any(o, d, scene.tri_v0, scene.tri_e0, scene.tri_e1, t_max).to(torch.int32)
    return _any_launch(o, d, scene, t_max)


@nondiff_kernel
def _any_launch(o, d, scene, t_max):
    o, d = o.contiguous(), d.contiguous()
    check_bvh_scene(scene, o, d)
    n = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_max = torch.broadcast_to(t_max, (n,)).contiguous()
    occ = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n:
        rc = _lib().bvh_anyhit(
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), *_tables(scene), n,
            occ.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream,
        )
        if rc:
            raise RuntimeError(f"bvh_anyhit launch failed: CUDA error {rc}")
        trace.count("launches.bvh_any_raw")
    return occ

