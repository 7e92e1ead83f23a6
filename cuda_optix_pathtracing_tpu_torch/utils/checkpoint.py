"""Film checkpoint/resume: the resumable state of a progressive render is
(film mean, film M2, N) plus the RNG seed — the counter-based RNG keeps no
other state. Plain .npz, the reference's format."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.film import Film


def save_film(path: str, film: Film, seed: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(
        tmp.removesuffix(".npz"),
        mean=film.mean.cpu().numpy(),
        m2=film.m2.cpu().numpy(),
        n=film.n.cpu().numpy(),
        seed=np.int64(seed),
    )
    os.replace(tmp, path)


def load_film(path: str, device=None) -> tuple[Film, int]:
    with np.load(path) as z:
        film = Film(
            *(torch.as_tensor(np.array(z[k]), device=device) for k in ("mean", "m2", "n"))
        )
        return film, int(z["seed"])
