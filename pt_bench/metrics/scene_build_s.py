"""Seconds the port took to build the scene on the card from the host scene
(``scene_from_host``: tables, the BVH builder, kernel tables)."""


def read(rec):
    return rec.scene_build_s
