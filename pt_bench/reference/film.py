"""Per-pixel Welford mean of a progressive film: one sample per update,
or a batch of S samples merged by Chan's parallel formula."""

from __future__ import annotations

import torch


def add_sample(mean, m2, n, radiance):
    """Welford update with one sample per pixel → (mean, m2, n)."""
    n = n + 1.0
    delta = radiance - mean
    mean = mean + delta / n
    return mean, m2 + delta * (radiance - mean), n


def add_batch(mean, m2, n, batch):
    """Merge S samples per pixel (S, ..., 3) → (mean, m2, n)."""
    s = batch.shape[0]
    b_mean = torch.mean(batch, dim=0)
    b_m2 = torch.sum(torch.square(batch - b_mean[None]), dim=0)
    nb = torch.full((), float(s), dtype=torch.float32, device=b_mean.device)
    n_new = n + nb
    safe = torch.clamp(n_new, min=1.0)
    delta = b_mean - mean
    return (mean + delta * (nb / safe), m2 + b_m2 + delta * delta * (n * nb / safe), n_new)


def accumulate(mean, m2, n, radiance, spp_per_pass: int):
    """A progressive batch's samples (kspp, ..., 3) into the film, one
    sample or ``spp_per_pass`` samples at a time."""
    for k in range(0, radiance.shape[0], spp_per_pass):
        if spp_per_pass > 1:
            mean, m2, n = add_batch(mean, m2, n, radiance[k:k + spp_per_pass])
        else:
            mean, m2, n = add_sample(mean, m2, n, radiance[k])
    return mean, m2, n
