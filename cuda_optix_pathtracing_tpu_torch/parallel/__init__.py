"""Rendering and training split over ranks (processes) with
``torch.distributed``: the film's pixels are sharded over a 1-D mesh of
ranks, the scene is replicated, and parameter gradients are averaged over
the ranks (counterpart of the reference ``parallel/``)."""

from .render import make_mesh, render_sharded, train_step_sharded  # noqa: F401
