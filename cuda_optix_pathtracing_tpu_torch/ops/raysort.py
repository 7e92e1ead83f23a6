"""Ray sorting before BVH traversal (counterpart of the reference
``ops/raysort.py``).

A ray batch is re-ordered by ``direction octant | origin Morton`` before
it goes to the traversal kernel and put back in its own order after, so
neighbouring threads trace rays that start near each other and head the
same way: their warps walk the same nodes and read the same triangles.
Dead rays get the largest key and gather at the end of the batch.

Keys are u32 values held in int64 tensors (torch has no u32 arithmetic).
The sort is stable: camera rays share one origin, so their keys collapse
to the 3 octant bits, and a stable sort keeps their Morton pixel order
within each octant (the reference's r5 note). The inverse is one scatter
by the saved index.
"""

from __future__ import annotations

import torch

DEAD_KEY = 0xFFFFFFFF
DEAD_KEY32 = 0x7FFFFFFF  # ray_sort_key32's dead key: after every live one


def _part3(v):
    """Spread 10 bits to every 3rd position (30-bit 3D Morton)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(x, y, z):
    return _part3(x) | (_part3(y) << 1) | (_part3(z) << 2)


def ray_sort_key(o, d, bounds_lo, bounds_hi, alive=None, morton_bits: int = 7):
    """(N,) int64 key holding a u32: [31:28] direction octant (sign bits
    of d), then the origin's 3D Morton code (``morton_bits`` per axis)
    top-aligned below it; dead rays get 0xFFFFFFFF."""
    octant = (
        (d[:, 0] < 0).to(torch.int64)
        | ((d[:, 1] < 0).to(torch.int64) << 1)
        | ((d[:, 2] < 0).to(torch.int64) << 2)
    )
    extent = torch.clamp(bounds_hi - bounds_lo, min=1e-6)
    q = torch.clamp((o - bounds_lo) / extent, 0.0, 1.0)
    qi = (q * float((1 << morton_bits) - 1)).to(torch.int64)
    m = morton3(qi[:, 0], qi[:, 1], qi[:, 2])
    key = (octant << 28) | (m << (28 - 3 * morton_bits))
    if alive is not None:
        key = torch.where(alive, key, DEAD_KEY)
    return key


def ray_sort_key32(o, d, bounds_lo, bounds_hi, alive):
    """``ray_sort_key`` as an (N,) int32, the depth-sorted wavefront's key:
    a live key's u32 value has bit 31 clear (3 octant bits at 28-30), so it
    is kept as is, and a dead ray gets ``DEAD_KEY32``; the int32 order is
    then ``ray_sort_key``'s u32 order, dead rays last."""
    key = ray_sort_key(o, d, bounds_lo, bounds_hi)
    return torch.where(alive, key, DEAD_KEY32).to(torch.int32)


def scene_bounds(v0, e0, e1):
    """AABB of the triangle soup → ((3,), (3,))."""
    p1 = v0 + e0
    p2 = v0 + e1
    lo = torch.minimum(torch.minimum(v0, p1), p2).amin(dim=0)
    hi = torch.maximum(torch.maximum(v0, p1), p2).amax(dim=0)
    return lo, hi


def _unsort(idx, x):
    out = torch.empty_like(x)
    out[idx] = x
    return out


def sorted_apply(o, d, key, fn):
    """``fn(o_sorted, d_sorted)`` → a tensor or a tuple of (N,) tensors,
    run on the rays stably sorted by ``key`` and returned in the rays'
    own order."""
    idx = torch.sort(key, stable=True).indices
    outs = fn(o[idx], d[idx])
    if isinstance(outs, tuple):
        return tuple(_unsort(idx, x) for x in outs)
    return _unsort(idx, outs)


def sorted_apply_tmax(o, d, t_max, key, fn):
    """Like :func:`sorted_apply` with a per-ray ``t_max`` sorted along:
    ``fn(o_sorted, d_sorted, t_max_sorted)`` → one (N,) tensor."""
    idx = torch.sort(key, stable=True).indices
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (o.shape[0],)
    )
    return _unsort(idx, fn(o[idx], d[idx], t_max[idx]))
