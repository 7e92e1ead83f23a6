from .procedural import cornell_box
from .types import HostScene, Scene, scene_from_arrays, scene_from_host, scene_to

__all__ = [
    "HostScene", "Scene", "cornell_box", "scene_from_arrays",
    "scene_from_host", "scene_to",
]
