"""Piecewise-constant 1D/2D distributions (counterpart of the reference
``ops/distrib.py``): tables of CDFs, sampled by inverse CDF through
``torch.searchsorted``. The reference's one-hot matrix gathers (a TPU
idiom) become plain indexing. All functions are batched over the samples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Piecewise1D(NamedTuple):
    func: torch.Tensor  # (N,) non-negative function values
    cdf: torch.Tensor  # (N+1,) cumulative, cdf[-1] == 1
    func_int: torch.Tensor  # () integral of func over [0, 1]


def make_piecewise_1d(func) -> Piecewise1D:
    func = torch.abs(torch.as_tensor(func, dtype=torch.float32))
    n = func.shape[-1]
    integral = func.sum(-1) / n
    safe = torch.where(integral > 0, integral, 1.0)
    cdf = torch.cat(
        [torch.zeros(func.shape[:-1] + (1,)), torch.cumsum(func / (n * safe[..., None]), -1)],
        dim=-1,
    )
    uniform = torch.linspace(0.0, 1.0, n + 1)
    cdf = torch.where(integral[..., None] > 0, cdf, uniform)
    cdf[..., -1] = 1.0  # exactly 1 at the end (uniform if the integral is 0)
    return Piecewise1D(func, cdf, integral)


def sample_piecewise_1d(d: Piecewise1D, u):
    """u ∈ [0, 1) → (x ∈ [0, 1), pdf, index)."""
    n = d.func.shape[-1]
    idx = torch.clamp(torch.searchsorted(d.cdf, u, right=True) - 1, 0, n - 1)
    c0 = d.cdf[idx]
    c1 = d.cdf[idx + 1]
    du = (u - c0) / torch.clamp(c1 - c0, min=1e-12)
    x = (idx.to(torch.float32) + du) / n
    return x, _pdf(d.func[idx], d.func_int), idx


def _pdf(f, func_int):
    safe_int = torch.where(func_int > 0, func_int, 1.0)
    return torch.where(func_int > 0, f / safe_int, 1.0)


def pdf_piecewise_1d(d: Piecewise1D, x):
    n = d.func.shape[-1]
    idx = torch.clamp((x * n).to(torch.int64), 0, n - 1)
    return _pdf(d.func[idx], d.func_int)


class Piecewise2D(NamedTuple):
    """Row-major (H rows = y, W columns = x) 2D distribution: a marginal
    over rows and per-row conditionals, all dense."""

    func: torch.Tensor  # (H, W)
    cond_cdf: torch.Tensor  # (H, W+1) conditional CDFs per row
    cond_int: torch.Tensor  # (H,) per-row integrals
    marg_cdf: torch.Tensor  # (H+1,)
    func_int: torch.Tensor  # ()

    def to(self, device) -> "Piecewise2D":
        return Piecewise2D(*(x.to(device) for x in self))


def make_piecewise_2d(func) -> Piecewise2D:
    """Tables built in numpy, as the reference builds them."""
    func = np.abs(np.asarray(func, np.float32))
    h, w = func.shape
    cond_int = func.sum(axis=1) / w
    safe_row = np.where(cond_int > 0, cond_int, 1.0)
    cond_cdf = np.concatenate(
        [np.zeros((h, 1), np.float32), np.cumsum(func / (w * safe_row[:, None]), axis=1)],
        axis=1,
    )
    uniform = np.linspace(0.0, 1.0, w + 1, dtype=np.float32)[None, :]
    cond_cdf = np.where(cond_int[:, None] > 0, cond_cdf, uniform)
    cond_cdf[:, -1] = 1.0

    func_int = cond_int.sum() / h
    safe_int = func_int if func_int > 0 else 1.0
    marg_cdf = np.concatenate([[0.0], np.cumsum(cond_int / (h * safe_int))]).astype(np.float32)
    if func_int <= 0:
        marg_cdf = np.linspace(0.0, 1.0, h + 1, dtype=np.float32)
    marg_cdf[-1] = 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return Piecewise2D(t(func), t(cond_cdf), t(cond_int), t(marg_cdf), t(func_int))


def sample_piecewise_2d(d: Piecewise2D, u1, u2):
    """(u1, u2) → (x, y) ∈ [0, 1)² and the pdf in unit-square measure:
    the row from u2 through the marginal, the column from u1 through that
    row's conditional."""
    h, w = d.func.shape
    row = torch.clamp(torch.searchsorted(d.marg_cdf, u2, right=True) - 1, 0, h - 1)
    m0 = d.marg_cdf[row]
    m1 = d.marg_cdf[row + 1]
    dv = (u2 - m0) / torch.clamp(m1 - m0, min=1e-12)
    y = (row.to(torch.float32) + dv) / h
    ccdf = d.cond_cdf[row]  # (N, W+1)
    col = torch.searchsorted(ccdf, u1[..., None], right=True)[..., 0]
    col = torch.clamp(col - 1, 0, w - 1)
    c0 = ccdf.gather(-1, col[..., None])[..., 0]
    c1 = ccdf.gather(-1, (col + 1)[..., None])[..., 0]
    du = (u1 - c0) / torch.clamp(c1 - c0, min=1e-12)
    x = (col.to(torch.float32) + du) / w
    return x, y, _pdf(d.func[row, col], d.func_int)


def pdf_piecewise_2d(d: Piecewise2D, x, y):
    h, w = d.func.shape
    col = torch.clamp((x * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((y * h).to(torch.int64), 0, h - 1)
    return _pdf(d.func[row, col], d.func_int)
