"""The BSDF stage of the unfused bounce (``megakernel.bounce_step``, span
``pt.bsdf``): each live path samples its material about the shading
normal (RNG dims ``BSDF_U``, ``BSDF_UC``), updates its throughput and
transmission state, meets Russian roulette (dim ``RR``) from
``cfg.rr_start_depth`` on and spawns its next ray; a path that ends keeps
its state. Textured scenes carry the ray cone, light-tree scenes the
shading normal (``prev_n``).

Two versions with the same values:

- ``bsdf_step``: one launch of ``pt_bsdf_step`` (``csrc/bsdf_step.cu``),
  one thread a row, for CUDA rows; it raises for any other. Each launch
  adds 1 to the counter ``launches.bsdf_step`` (``utils/trace.py``);
- ``bsdf_step_plain``: the stage as PyTorch ops, the kernel's plain
  version. ``bounce_step`` takes it on CPU rows, with
  ``backend="torch"`` and wherever autograd records the trace (the kernel
  has no backward).

Both return a new ``PathState``; ``radiance`` passes through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import _cuda_build
from ..ops import rng as R
from ..ops.bsdf import sample_bsdf
from ..ops.shade_tables import _epoly
from ..ops.vecmath import max_component, offset_ray_origin, sqr
from ..utils import trace
from .megakernel_cuda import _sampler_code, fused_keys

# spread of a path after its first non-specular bounce: a diffuse
# reflection's footprint grows like a wide cone, pulling deeper bounces
# toward the coarsest (and cheapest) mips
DIFFUSE_CONE_SPREAD = 0.3


def bsdf_step_plain(cfg, sampler: R.Sampler, px, py, sample, depth, state, hit, mat, wo, ns,
                    alive, radiance, cone_at_hit):
    """The stage as PyTorch ops → the bounce's new ``PathState``. ``hit``
    the closest hits, ``mat`` the gathered (and textured) material rows,
    ``wo = -state.d``, ``ns`` the shading normal, ``alive`` the paths that
    hit (``state.alive & hit.hit``), ``radiance`` the bounce's, and
    ``cone_at_hit`` the ray cone's width at the hit in textured scenes
    (else None)."""
    depth_dim = depth * R.DIMS_PER_BOUNCE
    u1, u2 = sampler.sample_2d(px, py, sample, depth_dim + R.Dim.BSDF_U)
    uc = sampler.sample_1d(px, py, sample, depth_dim + R.Dim.BSDF_UC)
    bs = sample_bsdf(mat, wo, ns, hit.normal, u1, u2, uc, state.inside, ft=cfg.features)

    valid = bs.pdf > 0.0
    beta = state.beta * torch.where(
        valid[..., None], bs.f_cos / torch.clamp(bs.pdf, min=1e-12)[..., None], 1.0
    )
    alive = alive & valid
    o_new = offset_ray_origin(hit.pos, hit.error, hit.normal, bs.wi)
    inside = state.inside ^ (bs.refract & alive)
    eta_scale = torch.where(
        bs.refract & alive, state.eta_scale * sqr(bs.eta), state.eta_scale
    )

    # russian roulette on β·∏η² from rr_start_depth on
    rr_beta = max_component(beta) * eta_scale
    u_rr = sampler.sample_1d(px, py, sample, depth_dim + R.Dim.RR)
    q = torch.clamp(1.0 - rr_beta, min=0.0)
    do_rr = (rr_beta < 1.0) & (depth >= cfg.rr_start_depth)
    killed = do_rr & (u_rr < q)
    survived = torch.where(
        do_rr & ~killed, 1.0 / torch.clamp(1.0 - q, min=1e-6), 1.0
    )
    beta = beta * survived[..., None]
    alive = alive & ~killed

    cone_w = cone_s = None
    if cone_at_hit is not None:
        # ray cones: the width grows by spread·distance; the first
        # non-specular bounce widens the spread to the diffuse cone
        cone_w = torch.where(alive, cone_at_hit, state.cone_w)
        cone_s = torch.where(
            alive & ~bs.delta,
            torch.clamp(state.cone_s, min=DIFFUSE_CONE_SPREAD),
            state.cone_s,
        )

    a3 = alive[..., None]
    return state._replace(
        o=torch.where(a3, o_new, state.o),
        d=torch.where(a3, bs.wi, state.d),
        beta=torch.where(a3, beta, state.beta),
        radiance=radiance,
        alive=alive,
        inside=inside,
        eta_scale=eta_scale,
        prev_pdf=torch.where(alive, bs.pdf, state.prev_pdf),
        prev_delta=torch.where(alive, bs.delta, state.prev_delta),
        cone_w=cone_w,
        cone_s=cone_s,
        prev_n=None if state.prev_n is None else torch.where(a3, ns, state.prev_n),
    )


_P = ctypes.c_void_p


class _Args(ctypes.Structure):
    """``BsdfStepArgs`` of ``csrc/bsdf_step.cu``, field for field."""

    _fields_ = [
        (name, _P) for name in (
            "o", "d", "beta", "eta_scale", "prev_pdf", "alive", "inside", "prev_delta",
            "cone_w", "cone_s", "cone_at_hit", "prev_n", "ns", "pos", "error", "normal",
            "mtype", "albedo", "on_sigma", "alphax", "alphay", "phi0", "eta", "refl_tint",
            "trans_tint", "cond_eta", "cond_k", "px", "py", "sample", "depth", "epoly",
            "o_out", "d_out", "beta_out", "eta_scale_out", "prev_pdf_out", "alive_out",
            "inside_out", "prev_delta_out", "cone_w_out", "cone_s_out", "prev_n_out",
        )
    ] + [
        ("n", ctypes.c_longlong), ("depth0", ctypes.c_longlong), ("sample0", ctypes.c_uint32),
        ("seed", ctypes.c_uint32), ("rr_start_depth", ctypes.c_int), ("sampler", ctypes.c_int),
        ("qmc_dims", ctypes.c_int), ("features", ctypes.c_int),
    ]


@functools.cache
def _lib():
    lib = _cuda_build.load("bsdf_step")
    lib.pt_bsdf_step.argtypes = [ctypes.POINTER(_Args), _P]
    lib.pt_bsdf_step.restype = ctypes.c_int
    return lib


@functools.cache
def _epoly_on(device: torch.device) -> torch.Tensor:
    """The E/Eavg polynomial coefficients on ``device``, copied once."""
    return torch.from_numpy(_epoly()).to(device)


def _features(ft) -> int:
    """``MatFeatures`` as the kernel's FT_* bits."""
    flags = (ft.oren_nayar, ft.lambert, ft.ggx, ft.conductor, ft.transmission, ft.aniso)
    return sum(1 << i for i, on in enumerate(flags) if on)


def bsdf_step(cfg, sampler: R.Sampler, px, py, sample, depth, state, hit, mat, wo, ns,
              alive, radiance, cone_at_hit):
    """``bsdf_step_plain``'s values in one launch of ``pt_bsdf_step`` on
    the current stream, for CUDA rows (the arguments as there; ``wo`` is
    ``-state.d``, which the kernel negates itself). The RNG keys go in
    place as ``fused_keys`` takes them; a tensor ``depth`` (one a row) as
    an (N,) int64 tensor. Raises for rows off the card or of another dtype
    or shape; allocates the new state and does not synchronise."""
    dev = state.o.device
    if dev.type != "cuda":
        raise ValueError("pt_bsdf_step needs CUDA rows")
    n = state.o.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def col(x, dtype, width=None):
        shape = (n,) if width is None else (n, width)
        if x.device != dev or x.dtype != dtype or x.shape != shape:
            raise ValueError(
                f"pt_bsdf_step takes {dtype} rows of shape {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        return x.contiguous()

    textured = cone_at_hit is not None
    tree = state.prev_n is not None
    ins = {
        "o": col(state.o, f32, 3), "d": col(state.d, f32, 3), "beta": col(state.beta, f32, 3),
        "eta_scale": col(state.eta_scale, f32), "prev_pdf": col(state.prev_pdf, f32),
        "alive": col(alive, b8), "inside": col(state.inside, b8),
        "prev_delta": col(state.prev_delta, b8),
        "ns": col(ns, f32, 3), "pos": col(hit.pos, f32, 3), "error": col(hit.error, f32, 3),
        "normal": col(hit.normal, f32, 3),
        "mtype": col(mat.mtype, i32), "albedo": col(mat.albedo, f32, 3),
        "on_sigma": col(mat.on_sigma, f32), "alphax": col(mat.alphax, f32),
        "alphay": col(mat.alphay, f32), "phi0": col(mat.phi0, f32), "eta": col(mat.eta, f32),
        "refl_tint": col(mat.refl_tint, f32, 3), "trans_tint": col(mat.trans_tint, f32, 3),
        "cond_eta": col(mat.cond_eta, f32, 3), "cond_k": col(mat.cond_k, f32, 3),
    }
    if textured:
        ins |= {"cone_w": col(state.cone_w, f32), "cone_s": col(state.cone_s, f32),
                "cone_at_hit": col(cone_at_hit, f32)}
    if tree:
        ins["prev_n"] = col(state.prev_n, f32, 3)
    kpx, kpy, ks, sample0 = fused_keys(px, py, sample, n, dev)
    ins |= {"px": kpx, "py": kpy, "sample": ks, "epoly": _epoly_on(dev)}
    depth0 = 0
    if torch.is_tensor(depth):
        ins["depth"] = torch.broadcast_to(depth.to(device=dev, dtype=torch.int64), (n,)).contiguous()
    else:
        depth0 = int(depth)

    def empty(dtype, width=None):
        return torch.empty((n,) if width is None else (n, width), dtype=dtype, device=dev)

    outs = {
        "o": empty(f32, 3), "d": empty(f32, 3), "beta": empty(f32, 3), "eta_scale": empty(f32),
        "prev_pdf": empty(f32), "alive": empty(b8), "inside": empty(b8),
        "prev_delta": empty(b8),
        "cone_w": empty(f32) if textured else None, "cone_s": empty(f32) if textured else None,
        "prev_n": empty(f32, 3) if tree else None,
    }
    args = _Args(
        **{k: None if v is None else v.data_ptr() for k, v in ins.items()},
        **{f"{k}_out": None if v is None else v.data_ptr() for k, v in outs.items()},
        n=n, depth0=depth0, sample0=sample0, seed=sampler.seed & R.M32,
        rr_start_depth=cfg.rr_start_depth, sampler=_sampler_code(sampler.kind, sampler.qmc_dims),
        qmc_dims=sampler.qmc_dims, features=_features(cfg.features),
    )
    rc = _lib().pt_bsdf_step(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"pt_bsdf_step launch failed: CUDA error {rc}")
    if n:
        trace.count("launches.bsdf_step")
    return state._replace(radiance=radiance, **outs)
