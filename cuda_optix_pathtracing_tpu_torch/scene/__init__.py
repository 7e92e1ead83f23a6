from .parser import load_scene
from .pbrt import load_pbrt
from .procedural import cornell_box, cornell_box_mesh, cornell_box_mesh_instanced
from .types import HostScene, Scene, scene_from_arrays, scene_from_host, scene_to

__all__ = [
    "HostScene", "Scene", "cornell_box", "cornell_box_mesh", "cornell_box_mesh_instanced",
    "load_pbrt", "load_scene",
    "scene_from_arrays", "scene_from_host", "scene_to",
]
