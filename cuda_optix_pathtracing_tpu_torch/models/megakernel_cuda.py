"""Wrapper of the fused path-tracing kernel (``csrc/megakernel.cu``), the
counterpart of the reference ``models/megakernel_pallas.py``.

``trace_paths_fused`` launches the kernel for CUDA tensors (one thread per
path, the whole depth loop in registers, scene tables in shared memory)
or raises; for CPU tensors it runs the kernel's plain version,
``models/megakernel.trace_paths`` with the plain intersection sweep.
``trace_paths_fused.launches`` counts kernel launches and nothing else.

Scope: brute-force intersection; Oren-Nayar, Lambert, GGX dielectric and
conductor; point, spot and area lights with uniform selection; constant
environment; hash sampler. The BVH mode and the single-depth mode of the
reference kernel come with slice 2, its Halton variant with slice 4.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import _cuda_build
from ..ops.bsdf import GGX_CONDUCTOR, GGX_DIELECTRIC, LAMBERT, OREN_NAYAR, _e_poly_coeffs
from ..ops.envmap import env_color
from ..ops.lights import AREA, PORTED_LIGHT_TYPES
from ..scene.types import Scene

MAT_ROWS = 24  # mtype, albedo3, on_sigma, alphax, alphay, phi0, eta,
# refl3, trans3, cond_eta3, cond_k3, emission3
LIGHT_ROWS = 13  # ltype, color3, pos3, direction3, cos_theta0, cos_theta_e, radius
EM_ROWS = 15  # v0 3, e0 3, e1 3, rad 3, cdf_lo, cdf_hi, total area
EPOLY_N = 7 * 7 + 7  # E(cos, alpha^2) and Eavg(alpha^2) coefficients, degree 6

MAX_SMEM_BYTES = 227 * 1024  # one block's dynamic shared memory on Hopper

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _cuda_build.load("megakernel")
    lib.pt_fused_bruteforce.argtypes = [_P] * 6 + [_I] * 7 + [_P] * 2
    lib.pt_fused_bruteforce.restype = _I
    return lib


@functools.cache
def _epoly() -> np.ndarray:
    """The 49 E and 7 Eavg polynomial coefficients, float32."""
    coef2d, coef1d, deg = _e_poly_coeffs()
    if deg != 6:
        raise ValueError(f"csrc/megakernel.cu hard-codes degree 6, got {deg}")
    return np.concatenate([coef2d.ravel(), coef1d]).astype(np.float32)


def table_bytes(scene: Scene) -> int:
    """Shared memory the kernel needs for this scene's tables."""
    k = scene.emissive.v0.shape[0] if scene.emissive is not None else 0
    floats = (
        10 * scene.num_triangles
        + MAT_ROWS * scene.materials.mtype.shape[0]
        + LIGHT_ROWS * scene.num_lights
        + EM_ROWS * k
        + 3
        + EPOLY_N
    )
    return 4 * floats


def megakernel_cuda_supported(scene: Scene, cfg) -> bool:
    """Can the fused kernel render (scene, cfg)? Counterpart of the
    reference ``pallas_megakernel_supported`` without the BVH and Halton
    branches (not ported yet)."""
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
    return table_bytes(scene) <= MAX_SMEM_BYTES


def _shade_tables(scene: Scene):
    """Row-per-entry tables: materials (M,24), lights (L,13), env colour
    (3,), emissive triangles (K,15) [v0|e0|e1|rad|cdf_lo|cdf_hi|area]."""
    m = scene.materials
    col = lambda x: x.to(torch.float32).reshape(x.shape[0], -1)  # noqa: E731
    mat_tab = torch.cat(
        [
            col(m.mtype), m.albedo, col(m.on_sigma), col(m.alphax),
            col(m.alphay), col(m.phi0), col(m.eta), m.refl_tint, m.trans_tint,
            m.cond_eta, m.cond_k, m.emission,
        ],
        dim=1,
    )
    lt = scene.lights
    light_tab = torch.cat(
        [
            col(lt.ltype), lt.color, lt.pos, lt.direction, col(lt.cos_theta0),
            col(lt.cos_theta_e), col(lt.radius),
        ],
        dim=1,
    )
    if scene.emissive is not None:
        em = scene.emissive
        k = em.v0.shape[0]
        em_tab = torch.cat(
            [
                em.v0, em.e0, em.e1, em.rad, col(em.cdf[:-1]), col(em.cdf[1:]),
                em.area.reshape(1, 1).expand(k, 1),
            ],
            dim=1,
        )
    else:
        em_tab = torch.zeros((0, EM_ROWS), dtype=torch.float32, device=m.albedo.device)
    return mat_tab, light_tab, env_color(scene.env), em_tab


def _scene_tables(scene: Scene):
    """Brute-force tables: triangles (T,9) [v0|e0|e1], material ids (T,),
    and the shading tables."""
    tri = torch.cat([scene.tri_v0, scene.tri_e0, scene.tri_e1], dim=1)
    return (tri, scene.tri_mat) + _shade_tables(scene)


def pack_tables(scene: Scene) -> torch.Tensor:
    """One float32 blob in the kernel's shared-memory layout:
    tri (T,9) | material id (T) | materials (M,24) | lights (L,13) |
    emissive (K,15) | env colour (3) | E/Eavg coefficients (56)."""
    tri, mat_ids, mat_tab, light_tab, env, em_tab = _scene_tables(scene)
    epoly = torch.from_numpy(_epoly()).to(tri.device)
    parts = [tri, mat_ids.to(torch.float32), mat_tab, light_tab, em_tab, env, epoly]
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).contiguous()


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
    tables = pack_tables(scene)
    o, d = o.contiguous(), d.contiguous()
    px32 = _u32_as_i32(px, n, dev)
    py32 = _u32_as_i32(py, n, dev)
    ss32 = _u32_as_i32(torch.as_tensor(sample, dtype=torch.int64, device=dev) ^ seed, n, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    k = scene.emissive.v0.shape[0] if scene.emissive is not None else 0
    rc = _lib().pt_fused_bruteforce(
        o.data_ptr(), d.data_ptr(), px32.data_ptr(), py32.data_ptr(),
        ss32.data_ptr(), tables.data_ptr(),
        n, scene.num_triangles, scene.materials.mtype.shape[0],
        scene.num_lights, k, max_depth, rr_start_depth, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"pt_fused_bruteforce launch failed: CUDA error {rc}")
    trace_paths_fused.launches += 1
    return out


trace_paths_fused.launches = 0
