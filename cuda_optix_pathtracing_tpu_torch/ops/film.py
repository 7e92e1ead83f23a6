"""Film: per-pixel Welford mean + M2 (counterpart of the reference
``ops/film.py``). The triple (mean, m2, n) is also the checkpoint state
of a progressive render."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Film(NamedTuple):
    mean: torch.Tensor  # (H, W, 3)
    m2: torch.Tensor  # (H, W, 3)
    n: torch.Tensor  # () float32 samples accumulated so far


def film_new(height: int, width: int, device=None) -> Film:
    z = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    return Film(z, z.clone(), torch.zeros((), dtype=torch.float32, device=device))


def film_add_sample(film: Film, radiance) -> Film:
    """Welford update with one radiance sample per pixel (H, W, 3)."""
    n = film.n + 1.0
    delta = radiance - film.mean
    mean = film.mean + delta / n
    m2 = film.m2 + delta * (radiance - mean)
    return Film(mean, m2, n)


def film_add_batch(film: Film, radiance_batch) -> Film:
    """Welford update with S samples per pixel (S, H, W, 3): the batch's
    own mean/M2 merged into the running state (Chan et al.)."""
    s = radiance_batch.shape[0]
    b_mean = torch.mean(radiance_batch, dim=0)
    b_m2 = torch.sum(torch.square(radiance_batch - b_mean[None]), dim=0)
    nb = torch.full((), float(s), dtype=torch.float32, device=b_mean.device)
    return film_merge(film, Film(b_mean, b_m2, nb))


def film_merge(a: Film, b: Film) -> Film:
    """Parallel Welford merge (Chan et al.)."""
    n = a.n + b.n
    nb_safe = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.n / nb_safe)
    m2 = a.m2 + b.m2 + delta * delta * (a.n * b.n / nb_safe)
    return Film(mean, m2, n)


def film_variance(film: Film):
    """Per-pixel per-sample variance M2/N (biased, as the reference)."""
    return film.m2 / torch.clamp(film.n, min=1.0)


def film_sqrt_mse(film: Film):
    """Per-pixel sample standard deviation (the *_sqrt_mse image)."""
    return torch.sqrt(torch.clamp(film_variance(film), min=0.0))


def srgb_encode(linear):
    """Linear → sRGB transfer."""
    lin = torch.clamp(linear, 0.0, 1.0)
    return torch.where(
        lin <= 0.0031308, 12.92 * lin, 1.055 * torch.pow(lin, 1.0 / 2.4) - 0.055
    )


def to_uint8(img01):
    return torch.clamp(torch.round(img01 * 255.0), 0, 255).to(torch.uint8)
