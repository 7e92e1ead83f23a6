from . import differentiable
from .differentiable import fd_gradient_check, init_params, inject_params, make_loss, render_mean
from .megakernel import MegakernelConfig, render, render_progressive, resolve_fused, trace_paths

__all__ = [
    "MegakernelConfig", "differentiable", "fd_gradient_check", "init_params",
    "inject_params", "make_loss", "render", "render_mean", "render_progressive",
    "resolve_fused", "trace_paths",
]
