"""Wrapper of the fused path-tracing kernel (``csrc/megakernel.cu``), the
counterpart of the reference ``models/megakernel_pallas.py``.

``trace_paths_fused`` launches the kernel for CUDA tensors (one thread per
path, the whole depth loop in registers, shading tables in shared memory)
or raises; for CPU tensors it runs the kernel's plain version,
``models/megakernel.trace_paths`` with the plain intersection sweep.
``trace_paths_fused.launches`` counts kernel launches and nothing else.

Two modes, one kernel template: a brute-force scene's triangles go to
shared memory with the shading tables (``pt_fused_bruteforce``); a BVH
scene's node tables and packed triangles stay in global memory and each
thread walks the tree (``pt_fused_bvh``).

Scope: Oren-Nayar, Lambert, GGX dielectric and conductor; point, spot and
area lights with uniform selection; constant environment; hash sampler.
The reference kernel's single-depth mode (``trace_paths_fused_sorted``) and
its Halton variant are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import _cuda_build
from ..ops.bvh import STACK_SIZE
from ..ops.bvh_cuda import check_bvh_scene
from ..ops.bsdf import GGX_CONDUCTOR, GGX_DIELECTRIC, LAMBERT, OREN_NAYAR
from ..ops.lights import AREA, PORTED_LIGHT_TYPES
from ..ops.shade_tables import EM_ROWS, EPOLY_N, LIGHT_ROWS, MAT_ROWS
from ..scene.types import Scene

MAX_SMEM_BYTES = 227 * 1024  # one block's dynamic shared memory on Hopper

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _cuda_build.load("megakernel")
    lib.pt_fused_bruteforce.argtypes = [_P] * 6 + [_I] * 7 + [_P] * 2
    lib.pt_fused_bruteforce.restype = _I
    lib.pt_fused_bvh.argtypes = [_P] * 12 + [_I] * 6 + [_P] * 2
    lib.pt_fused_bvh.restype = _I
    return lib


def table_bytes(scene: Scene) -> int:
    """Shared memory the kernel needs for this scene's tables: the
    shading tables, plus the triangle rows and material ids of a
    brute-force scene (a BVH scene's stay in global memory)."""
    k = scene.emissive.v0.shape[0] if scene.emissive is not None else 0
    floats = (
        MAT_ROWS * scene.materials.mtype.shape[0]
        + LIGHT_ROWS * scene.num_lights
        + EM_ROWS * k
        + 3
        + EPOLY_N
    )
    if scene.bvh is None:
        floats += 10 * scene.num_triangles
    return 4 * floats


def megakernel_cuda_supported(scene: Scene, cfg) -> bool:
    """Can the fused kernel render (scene, cfg)? Counterpart of the
    reference ``pallas_megakernel_supported`` without its Halton branch
    (slice 4). The reference refuses BVH scenes whose node meta table
    exceeds 255 KB, the TPU's SMEM budget for kernel inputs; here the node
    tables stay in global memory, so only the traversal stack bounds the
    tree (its depth)."""
    if cfg.sampler != "hash" or cfg.env_nee:
        return False
    if cfg.light_strategy == "tree" or cfg.pixel_filter != "box":
        return False
    mtypes = set(scene.materials.mtype.cpu().tolist())
    if not mtypes <= {OREN_NAYAR, GGX_DIELECTRIC, GGX_CONDUCTOR, LAMBERT}:
        return False
    ltypes = set(scene.lights.ltype.cpu().tolist())
    if not ltypes <= set(PORTED_LIGHT_TYPES):
        return False
    if AREA in ltypes and scene.emissive is None:
        return False
    if scene.bvh is not None and 7 * scene.bvh.depth + 1 > STACK_SIZE:
        return False
    return table_bytes(scene) <= MAX_SMEM_BYTES


def _shade(scene: Scene) -> torch.Tensor:
    if scene.shade_tables is None:
        raise ValueError(
            "the scene has no shade_tables; build it with scene_from_host or "
            "scene_from_arrays (ops/shade_tables.pack_shade_tables)"
        )
    return scene.shade_tables


def pack_tables(scene: Scene) -> torch.Tensor:
    """The brute-force kernel's blob: tri (T,9) [v0|e0|e1] | material id
    (T) | the scene's shading tables."""
    tri = torch.cat([scene.tri_v0, scene.tri_e0, scene.tri_e1], dim=1)
    parts = [tri.reshape(-1), scene.tri_mat.to(torch.float32), _shade(scene)]
    return torch.cat(parts).contiguous()


def _u32_as_i32(x, n, device):
    """(n,) int32 tensor holding the u32 bit patterns of int64 ``x``."""
    x = torch.as_tensor(x, dtype=torch.int64, device=device) & 0xFFFFFFFF
    x = torch.where(x >= 2**31, x - 2**32, x)
    return torch.broadcast_to(x, (n,)).to(torch.int32).contiguous()


def trace_paths_fused(
    scene: Scene, px, py, sample, o, d,
    max_depth: int = 5, rr_start_depth: int = 2, seed: int = 0,
    sampler: str = "hash",
):
    """Fused-path-loop radiance (N,3) for rays (o, d) — drop-in for
    ``megakernel.trace_paths`` on supported scenes (forward only)."""
    if sampler != "hash":
        raise NotImplementedError(
            "the fused kernel's Halton variant is not ported yet (slice 4)"
        )
    if not o.is_cuda:
        from .megakernel import MegakernelConfig, trace_paths

        cfg = MegakernelConfig(
            max_depth=max_depth, rr_start_depth=rr_start_depth, seed=seed,
            backend="torch", fused="off",
        )
        return trace_paths(scene, cfg, px, py, sample, o, d, device=o.device)

    dev = o.device
    if scene.device != dev:
        raise ValueError(f"scene is on {scene.device}, rays on {dev}")
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or o.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError("o and d must be (N, 3) float32")
    if table_bytes(scene) > MAX_SMEM_BYTES:
        raise ValueError(
            f"scene tables need {table_bytes(scene)} B of shared memory, more "
            f"than the fused kernel's {MAX_SMEM_BYTES} B"
        )
    o, d = o.contiguous(), d.contiguous()
    px32 = _u32_as_i32(px, n, dev)
    py32 = _u32_as_i32(py, n, dev)
    ss32 = _u32_as_i32(torch.as_tensor(sample, dtype=torch.int64, device=dev) ^ seed, n, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    k = scene.emissive.v0.shape[0] if scene.emissive is not None else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_mats = scene.materials.mtype.shape[0]
    if scene.bvh is not None:
        check_bvh_scene(scene, o, d)
        rc = _lib().pt_fused_bvh(
            o.data_ptr(), d.data_ptr(), px32.data_ptr(), py32.data_ptr(),
            ss32.data_ptr(), _shade(scene).data_ptr(), scene.bvh.box.data_ptr(),
            scene.bvh.meta.data_ptr(), scene.tri_v0.data_ptr(), scene.tri_e0.data_ptr(),
            scene.tri_e1.data_ptr(), scene.tri_mat.data_ptr(),
            n, n_mats, scene.num_lights, k, max_depth, rr_start_depth, out.data_ptr(),
            stream,
        )
    else:
        tables = pack_tables(scene)
        rc = _lib().pt_fused_bruteforce(
            o.data_ptr(), d.data_ptr(), px32.data_ptr(), py32.data_ptr(),
            ss32.data_ptr(), tables.data_ptr(),
            n, scene.num_triangles, n_mats, scene.num_lights, k, max_depth,
            rr_start_depth, out.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError(f"fused kernel launch failed: CUDA error {rc}")
    trace_paths_fused.launches += 1
    return out


trace_paths_fused.launches = 0
