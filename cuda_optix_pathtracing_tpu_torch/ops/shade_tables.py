"""The fused kernels' tables (``csrc/megakernel.cu``) packed into float32
blobs, in the kernels' shared-memory layout: the shading tables of every
scene, and a brute-force scene's whole blob, its triangle rows followed
by the shading tables.

The scene builders call ``pack_shade_tables`` and ``pack_brute_tables``
once per scene and keep the blobs on the ``Scene``, so no kernel launch
packs them; the kernels' wrapper (``models/megakernel_cuda.py``) only
reads them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bsdf import MaterialTable, _e_poly_coeffs
from .envmap import EnvMap, env_color
from .lights import EmissiveTable, LightTable

MAT_ROWS = 24  # mtype, albedo3, on_sigma, alphax, alphay, phi0, eta,
# refl3, trans3, cond_eta3, cond_k3, emission3
LIGHT_ROWS = 13  # ltype, color3, pos3, direction3, cos_theta0, cos_theta_e, radius
EM_ROWS = 15  # v0 3, e0 3, e1 3, rad 3, cdf_lo, cdf_hi, total area
EPOLY_N = 7 * 7 + 7  # E(cos, alpha^2) and Eavg(alpha^2) coefficients, degree 6
BRUTE_ROW_WORDS = 12  # [v0, material id | e0, 0 | e1, 0]: three float4s


@functools.cache
def _epoly() -> np.ndarray:
    """The 49 E and 7 Eavg polynomial coefficients, float32."""
    coef2d, coef1d, deg = _e_poly_coeffs()
    if deg != 6:
        raise ValueError(f"csrc/megakernel.cu hard-codes degree 6, got {deg}")
    return np.concatenate([coef2d.ravel(), coef1d]).astype(np.float32)


def pack_shade_tables(
    materials: MaterialTable, lights: LightTable, env: EnvMap,
    emissive: EmissiveTable | None,
) -> torch.Tensor:
    """(S,) float32: materials (M,24) | lights (L,13) | emissive triangles
    (K,15) [v0|e0|e1|rad|cdf_lo|cdf_hi|area] | env colour (3) | E/Eavg
    coefficients (56)."""
    m = materials
    col = lambda x: x.to(torch.float32).reshape(x.shape[0], -1)  # noqa: E731
    mat_tab = torch.cat(
        [
            col(m.mtype), m.albedo, col(m.on_sigma), col(m.alphax),
            col(m.alphay), col(m.phi0), col(m.eta), m.refl_tint, m.trans_tint,
            m.cond_eta, m.cond_k, m.emission,
        ],
        dim=1,
    )
    lt = lights
    light_tab = torch.cat(
        [
            col(lt.ltype), lt.color, lt.pos, lt.direction, col(lt.cos_theta0),
            col(lt.cos_theta_e), col(lt.radius),
        ],
        dim=1,
    )
    if emissive is not None:
        em = emissive
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
    epoly = torch.from_numpy(_epoly()).to(mat_tab.device)
    parts = [mat_tab, light_tab, em_tab, env_color(env), epoly]
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).contiguous()


def pack_brute_tables(v0, e0, e1, tri_mat, shade: torch.Tensor) -> torch.Tensor:
    """(T·12 + S,) float32: the brute-force fused kernel's shared-memory
    blob, triangle rows ``[v0, material id | e0, 0 | e1, 0]`` (the id as
    int32 bits; three 16-byte loads a row) then the shading tables
    ``shade`` (``pack_shade_tables``)."""
    rows = torch.zeros((v0.shape[0], BRUTE_ROW_WORDS), dtype=torch.float32, device=v0.device)
    rows[:, 0:3], rows[:, 4:7], rows[:, 8:11] = v0, e0, e1
    rows[:, 3] = tri_mat.to(torch.int32).view(torch.float32)
    return torch.cat([rows.reshape(-1), shade]).contiguous()
