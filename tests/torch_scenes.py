"""Scenes built identically in the JAX reference and the PyTorch port: the
builders take the package's own HostScene, bsdf, lights and CameraConfig,
so this module imports neither package (the port's GPU tests run where no
JAX is installed)."""

import numpy as np


def build_mixed(host_cls, bsdf, lights, cam_cls, width: int, height: int):
    """Conductor slab, Lambert floor and a two-triangle emissive quad
    (uneven areas) lit also by a point light: the conductor, Lambert and
    area-light/MIS branches that the Cornell box does not reach. Build it
    with ``use_light_tree=False``."""
    hs = host_cls()
    hs.camera = cam_cls(width=width, height=height)
    floor = [
        np.array([[-2, 0, -1], [2, 0, -1], [2, 4, -1]], np.float32),
        np.array([[-2, 0, -1], [2, 4, -1], [-2, 4, -1]], np.float32),
    ]
    slab = [
        np.array([[-1, 1.5, -0.2], [1, 1.5, -0.2], [1, 2.5, 0.6]], np.float32),
        np.array([[-1, 1.5, -0.2], [1, 2.5, 0.6], [-1, 2.5, 0.6]], np.float32),
    ]
    lamp = [
        np.array([[-0.8, 1.6, 1.4], [0.8, 1.6, 1.4], [0.8, 2.6, 1.4]], np.float32),
        np.array([[-0.8, 1.6, 1.4], [0.8, 2.6, 1.4], [-0.3, 2.1, 1.4]], np.float32),
    ]
    hs.add_model(floor, 0)
    hs.add_model(slab, 1)
    hs.add_model(lamp, 2)
    hs.materials = [
        bsdf.lambert((0.6, 0.6, 0.6)),
        bsdf.ggx_conductor((0.2, 0.9, 1.4), (3.9, 2.5, 2.1), 0.0, 0.15, 0.15),
        bsdf.diffuse_light((6.0, 5.0, 4.0)),
    ]
    hs.lights = [lights.point_light((4.0, 4.0, 4.0), (1.0, 0.5, 2.0), 1e-3)]
    hs.env_color = (0.05, 0.05, 0.05)
    return hs
