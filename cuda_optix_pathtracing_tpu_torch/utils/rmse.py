"""RMSE quality metric between two images (counterpart of the reference
``utils/rmse.py``).

Images are loaded as 8- or 16-bit PNGs and normalised to [0, 1]; the
per-pixel RMSE is the square root of the channel-mean squared error, and
the scene's score is its mean over the pixels.

    python -m cuda_optix_pathtracing_tpu_torch.utils.rmse render.png ref.png
"""

from __future__ import annotations

import numpy as np

from .imageio import read_png


def load_unit_rgb(path: str) -> np.ndarray:
    """Load a PNG → float64 RGB in [0, 1] (grey repeated, alpha dropped)."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img.astype(np.float64) / float(np.iinfo(img.dtype).max)


def rmse_image(img: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-pixel RMSE map."""
    diff = np.asarray(img, np.float64) - np.asarray(ref, np.float64)
    return np.sqrt(np.mean(diff**2, axis=2))


def mean_rmse(img: np.ndarray, ref: np.ndarray) -> float:
    """Scene score: the mean of the per-pixel RMSE map."""
    if img.shape != ref.shape:
        raise ValueError(f"shape mismatch: {img.shape} vs {ref.shape}")
    return float(rmse_image(img, ref).mean())


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="dtpt-rmse-torch",
                                 description="mean RMSE between two images")
    ap.add_argument("image")
    ap.add_argument("reference")
    ap.add_argument("--save-rmse", default=None, help="write the RMSE map as a PNG")
    args = ap.parse_args(argv)
    img = load_unit_rgb(args.image)
    ref = load_unit_rgb(args.reference)
    r = rmse_image(img, ref)
    if args.save_rmse:
        from .imageio import write_png

        m = r / r.max() if r.max() > 0 else r
        write_png(args.save_rmse, (m * 255).astype(np.uint8))
    print(mean_rmse(img, ref))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
