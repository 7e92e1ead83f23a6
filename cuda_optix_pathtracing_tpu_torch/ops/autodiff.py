"""Autodiff helper for kernels with no backward (counterpart of the
reference ``ops/autodiff.py``).

The intersection kernels return discrete events (hit distances and
indices, occlusion flags) that are piecewise constant in the
differentiable parameters (albedo, emission, light colour, envmap
texels; the detached-sampling design of ``models/differentiable.py``).
Their derivative is zero almost everywhere; derivatives of shading
attributes flow through the recomputed epilogue
(``ops/intersect.closest_epilogue``), not through the kernel.
``nondiff_kernel`` wraps such a function so that autograd treats its
outputs as constants: zero gradient to every floating input.
"""

from __future__ import annotations

import functools
import inspect

import torch


def _requires_grad(args, kwargs) -> bool:
    return any(
        torch.is_tensor(a) and a.requires_grad for a in (*args, *kwargs.values())
    )


class _NonDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, *args):
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.mark_non_differentiable(
            *(o for o in outs if torch.is_tensor(o) and not o.is_floating_point())
        )
        ctx.floating = [
            (a.shape, a.dtype, a.device)
            if torch.is_tensor(a) and a.is_floating_point() else None
            for a in args
        ]
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(
            None if f is None else torch.zeros(f[0], dtype=f[1], device=f[2])
            for f in ctx.floating
        ))


def nondiff_kernel(fn):
    """Wrap ``fn(*args, **kwargs) -> tensor or tuple`` so that autograd
    treats its outputs as constants: zero gradient to every floating
    input, integer and bool outputs marked non-differentiable. Where grad
    is off or no tensor argument requires it, ``fn`` is called directly,
    with nothing added. ``fn`` takes no keyword-only arguments: keyword
    arguments are bound to their positions, so a tensor passed by keyword
    gets its zero gradient too."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not (torch.is_grad_enabled() and _requires_grad(args, kwargs)):
            return fn(*args, **kwargs)
        return _NonDiff.apply(fn, *sig.bind(*args, **kwargs).args)

    return wrapped
