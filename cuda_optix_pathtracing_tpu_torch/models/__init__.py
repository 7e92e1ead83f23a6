from .megakernel import MegakernelConfig, render, render_progressive, resolve_fused, trace_paths

__all__ = [
    "MegakernelConfig", "render", "render_progressive", "resolve_fused", "trace_paths",
]
