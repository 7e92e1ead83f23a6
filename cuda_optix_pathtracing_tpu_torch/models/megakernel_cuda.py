"""Wrappers of the path-tracing kernels (``csrc/megakernel.cu``), the
counterpart of the reference ``models/megakernel_pallas.py``.

``trace_paths_fused`` launches the fused kernel for CUDA tensors (the
whole depth loop in registers, shading tables in shared memory) or
raises; for CPU tensors it runs the kernel's plain version,
``models/megakernel.trace_paths`` with the plain intersection sweep. Two
modes: a brute-force scene's blob (``scene.brute_tables``, its 48 B
triangle rows and the shading tables, built once per scene) goes to shared
memory, one thread per path (``pt_fused_bruteforce``); a BVH
scene's compact node table (``scene.bvh.nodes``) and triangle rows
(``scene.tri_rows``) are read from global memory through the read-only
path, and persistent blocks regenerate paths, each lane taking the next
path from a counter as soon as its own ends (``pt_fused_bvh``).

``trace_paths_fused_sorted`` is the depth-sorted fused wavefront of BVH
scenes: one launch of the single-bounce kernel (``pt_bounce_bvh``, through
``bounce_fused``) per depth over a path state of one 96 B row per path
that stays in slot order; the kernel writes each path's next sort key,
one stable sort of the keys between depths gives the next launch its
permutation. Like the reference, ``render()`` never takes it.

``trace_paths_fused.launches`` and ``bounce_fused.launches`` count kernel
launches and nothing else.

Scope: Oren-Nayar, Lambert, GGX dielectric and conductor without
textures; flat shading (no shading normals); point, spot and area lights
with uniform selection; constant environment; the hash and the
Owen-scrambled Halton samplers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import _cuda_build
from ..ops import rng as R
from ..ops.bvh import stack_fits
from ..ops.bvh_cuda import check_bvh_scene
from ..ops.bsdf import GGX_CONDUCTOR, GGX_DIELECTRIC, LAMBERT, OREN_NAYAR
from ..ops.lights import AREA, POINT, SPOT
from ..ops.raysort import ray_sort_key32
from ..ops.shade_tables import BRUTE_ROW_WORDS, EM_ROWS, EPOLY_N, LIGHT_ROWS, MAT_ROWS
from ..scene.types import Scene

MAX_SMEM_BYTES = 227 * 1024  # one block's dynamic shared memory on Hopper
FUSED_LIGHT_TYPES = (POINT, SPOT, AREA)

SAMPLERS = {"hash": 0, "halton": 1}  # the kernels' sampler codes

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_SAMPLER_ARGS = [_I, _U, _I]  # sampler code, seed, qmc_dims


@functools.cache
def _lib():
    lib = _cuda_build.load("megakernel")
    lib.pt_fused_bruteforce.argtypes = [_P] * 6 + [_I] * 7 + _SAMPLER_ARGS + [_P] * 2
    lib.pt_fused_bruteforce.restype = _I
    bvh_args = [_P] * 3  # nodes, rows, tri_mat
    lib.pt_fused_bvh.argtypes = [_P] * 6 + bvh_args + [_I] * 6 + _SAMPLER_ARGS + [_P] * 3
    lib.pt_fused_bvh.restype = _I
    lib.pt_bounce_bvh.argtypes = [_P] * 5 + bvh_args + [_I] * 6 + _SAMPLER_ARGS + [_P] * 2
    lib.pt_bounce_bvh.restype = _I
    return lib


def table_bytes(scene: Scene) -> int:
    """Shared memory the kernel needs for this scene's tables: the
    shading tables, plus a brute-force scene's triangle rows (48 B each,
    the material id in a spare word; a BVH scene's stay in global
    memory): the size of ``scene.brute_tables`` or of
    ``scene.shade_tables``."""
    k = scene.emissive.v0.shape[0] if scene.emissive is not None else 0
    floats = (
        MAT_ROWS * scene.materials.mtype.shape[0]
        + LIGHT_ROWS * scene.num_lights
        + EM_ROWS * k
        + 3
        + EPOLY_N
    )
    if scene.bvh is None:
        floats += BRUTE_ROW_WORDS * scene.num_triangles
    return 4 * floats


def megakernel_cuda_supported(scene: Scene, cfg) -> bool:
    """Can the fused kernel render (scene, cfg)? Counterpart of the
    reference ``pallas_megakernel_supported``: either sampler; the pixel
    filter runs outside the kernel and is not checked. The reference
    refuses BVH scenes whose node meta table exceeds 255 KB, the TPU's SMEM
    budget for kernel inputs; here the node table is read from global
    memory, so only the traversal stacks bound the tree (its depth). Like
    the reference, it refuses textures, shading normals and an environment
    whose texels differ: the kernels shade with the table's constants and
    the geometric normal. It refuses instanced scenes and scenes with a
    light tree too: the kernels know one mesh in world space and select
    lights uniformly."""
    if scene.instances is not None or scene.light_tree is not None:
        return False
    if scene.textures is not None or scene.tri_ns is not None:
        return False
    if cfg.sampler not in SAMPLERS or cfg.env_nee:
        return False
    if cfg.light_strategy == "tree":
        return False
    mtypes = set(scene.materials.mtype.cpu().tolist())
    if not mtypes <= {OREN_NAYAR, GGX_DIELECTRIC, GGX_CONDUCTOR, LAMBERT}:
        return False
    ltypes = set(scene.lights.ltype.cpu().tolist())
    if not ltypes <= set(FUSED_LIGHT_TYPES):
        return False
    if AREA in ltypes and scene.emissive is None:
        return False
    if scene.bvh is not None and not stack_fits(scene.bvh.depth):
        return False
    # a constant environment only: the kernels read its colour from the
    # shading tables (optimised texels may differ, models/differentiable)
    img = scene.env.image.detach().cpu().reshape(-1, 3)
    if not bool((img == img[0]).all()):
        return False
    return table_bytes(scene) <= MAX_SMEM_BYTES


def _shade(scene: Scene) -> torch.Tensor:
    if scene.shade_tables is None:
        raise ValueError(
            "the scene has no shade_tables; build it with scene_from_host or "
            "scene_from_arrays (ops/shade_tables.pack_shade_tables)"
        )
    return scene.shade_tables


def _bvh_tables(scene: Scene):
    """The BVH kernels' table arguments: the compact nodes, the triangle
    rows and the material ids (``check_bvh_scene`` has checked them)."""
    return scene.bvh.nodes.data_ptr(), scene.tri_rows.data_ptr(), scene.tri_mat.data_ptr()


def _brute(scene: Scene) -> torch.Tensor:
    if scene.brute_tables is None:
        raise ValueError(
            "the scene has no brute_tables; build it with scene_from_host or "
            "scene_from_arrays (ops/shade_tables.pack_brute_tables)"
        )
    return scene.brute_tables


def _u32_as_i32(x, n, device):
    """(n,) int32 tensor holding the u32 bit patterns of int64 ``x``."""
    x = torch.as_tensor(x, dtype=torch.int64, device=device) & 0xFFFFFFFF
    x = torch.where(x >= 2**31, x - 2**32, x)
    return torch.broadcast_to(x, (n,)).to(torch.int32).contiguous()


def _sampler_code(sampler: str, qmc_dims: int) -> int:
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    if not 0 <= qmc_dims < 2**31:
        raise ValueError(f"qmc_dims must be >= 0, got {qmc_dims}")
    return SAMPLERS[sampler]


def _plain_cfg(max_depth, rr_start_depth, seed, sampler):
    from .megakernel import MegakernelConfig

    return MegakernelConfig(
        max_depth=max_depth, rr_start_depth=rr_start_depth, seed=seed, sampler=sampler,
        backend="torch", fused="off",
    )


def trace_paths_fused(
    scene: Scene, px, py, sample, o, d,
    max_depth: int = 5, rr_start_depth: int = 2, seed: int = 0,
    sampler: str = "hash", qmc_dims: int = R.QMC_DIMS,
):
    """Fused-path-loop radiance (N,3) for rays (o, d) — drop-in for
    ``megakernel.trace_paths`` on supported scenes (forward only)."""
    code = _sampler_code(sampler, qmc_dims)
    if not o.is_cuda:
        from .megakernel import trace_paths

        cfg = _plain_cfg(max_depth, rr_start_depth, seed, sampler)
        return trace_paths(scene, cfg, px, py, sample, o, d, device=o.device, qmc_dims=qmc_dims)

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
    s32 = _u32_as_i32(sample, n, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    k = scene.emissive.v0.shape[0] if scene.emissive is not None else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_mats = scene.materials.mtype.shape[0]
    smp = (code, seed & 0xFFFFFFFF, qmc_dims)
    if scene.bvh is not None:
        check_bvh_scene(scene, o, d)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        rc = _lib().pt_fused_bvh(
            o.data_ptr(), d.data_ptr(), px32.data_ptr(), py32.data_ptr(),
            s32.data_ptr(), _shade(scene).data_ptr(), *_bvh_tables(scene),
            n, n_mats, scene.num_lights, k, max_depth, rr_start_depth, *smp,
            counter.data_ptr(), out.data_ptr(), stream,
        )
    else:
        rc = _lib().pt_fused_bruteforce(
            o.data_ptr(), d.data_ptr(), px32.data_ptr(), py32.data_ptr(),
            s32.data_ptr(), _brute(scene).data_ptr(),
            n, scene.num_triangles, n_mats, scene.num_lights, k, max_depth,
            rr_start_depth, *smp, out.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError(f"fused kernel launch failed: CUDA error {rc}")
    trace_paths_fused.launches += 1
    return out


trace_paths_fused.launches = 0


# ---------------------------------------------------------------------------
# the depth-sorted fused wavefront
# ---------------------------------------------------------------------------

# columns of the (N, STATE_WORDS) path state, one row per path: 32-bit
# words, float32 or, for the flags and keys, int32 bit patterns (u32 keys
# as their low 32 bits)
O, D, BETA, RADIANCE = 0, 3, 6, 9  # three words each, f32
ALIVE, INSIDE, ETA_SCALE, PREV_PDF, PREV_DELTA = 12, 13, 14, 15, 16
PX, PY, SAMPLE, SLOT = 17, 18, 19, 20  # the keys the paths carry along
FIELDS = 21
STATE_WORDS = 24  # FIELDS padded to 96 B: six float4s


def pack_path_state(px, py, sample, o, d) -> torch.Tensor:
    """The (N, STATE_WORDS) float32 state of N fresh paths
    (``init_path_state``'s values) with their RNG keys and their slot, the
    ray's own index (the row's own index too: rows stay in slot order)."""
    n, dev = o.shape[0], o.device
    st = torch.zeros((n, STATE_WORDS), dtype=torch.float32, device=dev)
    si = st.view(torch.int32)
    st[:, O:O + 3] = o
    st[:, D:D + 3] = d
    st[:, BETA:BETA + 3] = 1.0
    si[:, ALIVE] = 1
    st[:, ETA_SCALE] = 1.0
    si[:, PREV_DELTA] = 1  # the camera counts as delta
    si[:, PX] = _u32_as_i32(px, n, dev)
    si[:, PY] = _u32_as_i32(py, n, dev)
    si[:, SAMPLE] = _u32_as_i32(sample, n, dev)
    si[:, SLOT] = torch.arange(n, dtype=torch.int32, device=dev)
    return st


def unpack_path_state(st: torch.Tensor):
    """(PathState, px, py, sample) of a packed state: (N, 3) and (N,)
    tensors, keys as int64 in [0, 2^32)."""
    from .megakernel import PathState

    si = st.view(torch.int32)
    v3 = lambda c: st[:, c:c + 3].contiguous()  # noqa: E731
    key = lambda c: si[:, c].to(torch.int64) & R.M32  # noqa: E731
    state = PathState(
        o=v3(O), d=v3(D), beta=v3(BETA), radiance=v3(RADIANCE),
        alive=si[:, ALIVE] != 0, inside=si[:, INSIDE] != 0, eta_scale=st[:, ETA_SCALE].clone(),
        prev_pdf=st[:, PREV_PDF].clone(), prev_delta=si[:, PREV_DELTA] != 0,
    )
    return state, key(PX), key(PY), key(SAMPLE)


def path_keys(scene: Scene, st: torch.Tensor) -> torch.Tensor:
    """(N,) int32 sort key of every row of the state for the next depth:
    ``ray_sort_key32`` of its ray, dead paths last. The plain version of
    the keys the single-bounce kernel writes."""
    alive = st.view(torch.int32)[:, ALIVE] != 0
    return ray_sort_key32(st[:, O:O + 3], st[:, D:D + 3], scene.bounds[0], scene.bounds[1], alive)


def bounce_plain(scene: Scene, st: torch.Tensor, depth: int, rr_start_depth: int = 2,
                 seed: int = 0, sampler: str = "hash", qmc_dims: int = R.QMC_DIMS) -> torch.Tensor:
    """The single-bounce kernel's plain version: ``bounce_step`` on the
    unpacked state, written back into ``st`` in place → ``path_keys``."""
    from .megakernel import bounce_step

    cfg = _plain_cfg(depth + 1, rr_start_depth, seed, sampler)
    state, px, py, sample = unpack_path_state(st)
    new = bounce_step(scene, cfg, R.Sampler(sampler, seed, qmc_dims), px, py, sample, depth, state)
    si = st.view(torch.int32)
    for c, v in ((O, new.o), (D, new.d), (BETA, new.beta), (RADIANCE, new.radiance)):
        st[:, c:c + 3] = v
    si[:, ALIVE] = new.alive.to(torch.int32)
    si[:, INSIDE] = new.inside.to(torch.int32)
    st[:, ETA_SCALE] = new.eta_scale
    st[:, PREV_PDF] = new.prev_pdf
    si[:, PREV_DELTA] = new.prev_delta.to(torch.int32)
    return path_keys(scene, st)


def bounce_fused(scene: Scene, st: torch.Tensor, depth: int, rr_start_depth: int = 2,
                 seed: int = 0, sampler: str = "hash", qmc_dims: int = R.QMC_DIMS,
                 perm: torch.Tensor | None = None) -> torch.Tensor:
    """One bounce at ``depth`` of every live path of the packed state
    ``st`` (``pack_path_state``), in place → each row's (N,) int32 sort key
    for the next depth (``path_keys``). The single-bounce kernel for a CUDA
    state, thread t on row ``perm[t]`` (int64, a permutation of the rows
    such as ``sort_paths`` gives, which the kernel trusts; the identity
    without one); its plain version ``bounce_plain`` for a CPU state, where
    the order of the rows' bounces does not matter."""
    code = _sampler_code(sampler, qmc_dims)
    if scene.bvh is None:
        raise ValueError("the single-bounce kernel traces BVH scenes only")
    n = st.shape[0]
    if st.dtype != torch.float32 or st.shape != (n, STATE_WORDS) or not st.is_contiguous():
        raise ValueError(f"the path state must be a contiguous (N, {STATE_WORDS}) float32 tensor")
    if perm is not None and (perm.shape != (n,) or perm.dtype != torch.int64
                             or perm.device != st.device or not perm.is_contiguous()):
        raise ValueError("perm must be a contiguous (N,) int64 tensor on the state's device")
    if not st.is_cuda:
        return bounce_plain(scene, st, depth, rr_start_depth, seed, sampler, qmc_dims)
    check_bvh_scene(scene, st[:, O:O + 3], st[:, D:D + 3])
    keys = torch.empty((n,), dtype=torch.int32, device=st.device)
    if n == 0:
        return keys
    counter = torch.zeros(1, dtype=torch.int32, device=st.device)
    k = scene.emissive.v0.shape[0] if scene.emissive is not None else 0
    rc = _lib().pt_bounce_bvh(
        st.data_ptr(), None if perm is None else perm.data_ptr(), keys.data_ptr(),
        scene.bounds.data_ptr(), _shade(scene).data_ptr(), *_bvh_tables(scene),
        n, scene.materials.mtype.shape[0], scene.num_lights, k, depth, rr_start_depth,
        code, seed & 0xFFFFFFFF, qmc_dims, counter.data_ptr(),
        torch.cuda.current_stream(st.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"single-bounce kernel launch failed: CUDA error {rc}")
    bounce_fused.launches += 1
    return keys


bounce_fused.launches = 0


def sort_paths(keys: torch.Tensor) -> torch.Tensor:
    """The order in which the next launch runs the rows: one stable sort of
    their int32 keys (``bounce_fused``, ``path_keys``) → (N,) int64 row
    indices, dead paths last, ties in slot order."""
    return torch.sort(keys, stable=True).indices


def trace_paths_fused_sorted(
    scene: Scene, px, py, sample, o, d,
    max_depth: int = 5, rr_start_depth: int = 2, seed: int = 0,
    sampler: str = "hash", qmc_dims: int = R.QMC_DIMS,
):
    """Depth-sorted fused wavefront → radiance (N,3) in the rays' own
    order; the same estimator as ``trace_paths_fused``. One single-bounce
    launch per depth over the packed state, which stays in slot order:
    depth 0 runs the rows as given (camera rays in Morton order), each
    later depth in the order of the keys the previous launch wrote
    (``sort_paths``: direction octant | origin Morton, dead paths last, ties
    by slot); the radiance is read from the rows at the end. The order
    only decides which thread runs which path, and a path's radiance
    depends on its own state and keys alone, so the result equals
    ``trace_paths_fused``'s bit for bit on the card, and, for CPU tensors,
    where every bounce is the plain ``bounce_step``, ``trace_paths``'s. BVH
    scenes only."""
    if scene.bvh is None:
        raise ValueError("the depth-sorted wavefront traces BVH scenes only")
    _sampler_code(sampler, qmc_dims)
    st = pack_path_state(px, py, sample, o, d)
    perm = None
    for depth in range(max_depth):
        keys = bounce_fused(scene, st, depth, rr_start_depth, seed, sampler, qmc_dims, perm=perm)
        if depth + 1 < max_depth:
            perm = sort_paths(keys)
    return st[:, RADIANCE:RADIANCE + 3].contiguous()
