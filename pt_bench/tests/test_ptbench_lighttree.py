"""The many-lights box against the benchmark's scene builder and its plain
light-tree reference, on the CPU.

- The builder ``pt_bench/scenes/many_lights.py`` gives the port the scene
  that the port's own ``cornell_box_many_lights`` builds, tensor for
  tensor.
- The reference's tree (``pt_bench/reference/lighttree.py``) is the port's
  ``build_light_tree`` on the configuration's scene: its features agree to
  1e-6 relative (both build in float64 and keep float32, so only a
  different order of the same float64 sums may move the last bits), its
  links, records and bit trails exactly. The descent picks a record by
  comparing a number with a probability, so only the same tree picks the
  same record sample by sample.
- The reference computes the port's estimator: the box with its spheres at
  8 x 8, 16², depth 5, 2 samples, the port's ``render_sample_batch``
  (``fused="off"``) against ``lighttree.pixel_samples`` on the same hash
  keys. All but 1 % of the pixels agree to 1e-4 relative: a descent level
  whose number lies within rounding of its probability may turn the other
  way in the two, and that pixel's sample then lights another record.
- A tiny tree cell added to a copy of the benchmark from files alone runs
  through the harness and reads correct under the limits of
  ``many_lights256_d5_tree``; with the radiance altered by 1 % where the
  renderer produces it, it reads not correct.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cuda_optix_pathtracing_tpu_torch.models import megakernel as MK
from cuda_optix_pathtracing_tpu_torch.scene.procedural import cornell_box_many_lights
from cuda_optix_pathtracing_tpu_torch.scene.types import HostScene, scene_from_host
from pt_bench import faults, harness

from .ptbench_cells import TINY, add_cell, add_config, make_root

torch.set_num_threads(2)

CELL = harness.load_cell("many_lights256_d5_tree")
SIZE, SUBDIV, DEPTH, SPP = 16, 8, 5, 2
SEED = 2**31 + 7
REL = 1e-4  # a pixel's agreement, relative
OFF_SHARE = 0.01  # pixels allowed past it


def _spec(**cfg):
    """(spec, builder) of the cell's configuration with ``cfg`` changed."""
    return harness.scene_spec(dataclasses.replace(CELL, config=dict(CELL.config, **cfg)))


def _port_scene(spec, builder):
    return scene_from_host(builder.to_host_scene(spec, HostScene), device="cpu")


@pytest.fixture(scope="module")
def small():
    """(spec, the port's scene) of the box at SIZE², spheres SUBDIV²."""
    spec, builder = _spec(width=SIZE, height=SIZE, sphere_lat=SUBDIV, sphere_lon=SUBDIV)
    return spec, _port_scene(spec, builder)


def test_builder_gives_the_ports_scene(small):
    spec, ours = small
    theirs = cornell_box_many_lights(SIZE, SIZE, subdiv=SUBDIV, device="cpu")

    def same(a, b, path):
        if torch.is_tensor(a):
            assert torch.equal(a, b), path
        elif isinstance(a, tuple):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}.{i}")
        else:
            assert a == b, path

    for name in ours._fields:
        same(getattr(ours, name), getattr(theirs, name), name)
    full, _ = _spec()
    assert full.tris.shape[0] == CELL.config["triangles"] == 16266
    emits = sum(1 for m in full.tri_mat if "emission" in full.materials[m])
    assert emits == CELL.config["emissive_triangles"] == 128
    assert ours.light_tree.n_records == CELL.config["light_records"] == 129


def test_reference_tree_is_the_ports(small):
    spec, builder = _spec()
    ref = CELL.reference
    tree, _ = ref.spec_light_tree(spec)
    port = _port_scene(spec, builder).light_tree
    feat = port.feat.numpy()
    assert feat.shape == (tree.nodes.shape[0], 15) and tree.depth == port.depth == 9
    np.testing.assert_allclose(feat[:, :12], tree.nodes, rtol=1e-6, atol=0)
    assert np.array_equal(np.round(feat[:, 12:]).astype(np.int64), tree.links)
    assert np.array_equal(port.rec_kind.numpy(), tree.rec_kind)
    assert np.array_equal(port.rec_idx.numpy(), tree.rec_idx)
    np.testing.assert_allclose(port.rec_energy.numpy(), tree.rec_energy, rtol=1e-6, atol=0)
    words = port.trail.numpy().astype(np.uint64)
    assert np.array_equal(words[:, 0] | (words[:, 1] << np.uint64(32)), tree.trail)
    assert np.array_equal(port.trail_len.numpy(), tree.trail_len)
    # each triangle's record, on the small box (no BVH, so in the spec's order)
    spec, scene = small
    assert scene.bvh is None
    assert np.array_equal(scene.tri_emrec.numpy(), ref.spec_light_tree(spec)[1])


def test_reference_matches_the_port(small):
    spec, scene = small
    ref = CELL.reference
    ys, xs = torch.meshgrid(torch.arange(SIZE), torch.arange(SIZE), indexing="ij")
    want = ref.pixel_samples(ref.make_scene(spec, "cpu"), ref.SAMPLERS["hash"](SEED),
                             xs.reshape(-1), ys.reshape(-1), 0, SPP, DEPTH)
    want = want.reshape(SPP, SIZE, SIZE, 3).sum(0).numpy()
    cfg = MK.MegakernelConfig(max_depth=DEPTH, remat=False, fused="off", seed=SEED)
    assert MK._tree_on(cfg, scene)
    got = MK.render_sample_batch(scene, cfg, SIZE, SIZE, 0, nspp=SPP).sum(0).numpy()
    assert np.isfinite(got).all() and got.mean() > 1e-2  # the box and its lights show
    off = (np.abs(got - want) > REL * np.abs(want)).any(-1)
    assert off.mean() <= OFF_SHARE, off.mean()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("bench"))
    add_config(root, "tiny_tree", dict(TINY, scene="many_lights", reference="lighttree"))
    add_cell(root, "tiny_tree.render", "tiny_tree", "tiny_render_pass", "many_lights256_d5_tree")
    return root


@pytest.mark.parametrize("fault", [None, "altered_answer"], ids=lambda f: f or "sound")
def test_tree_cell_from_files_alone(root, fault):
    cell = harness.load_cell("tiny_tree.render", root)
    assert cell.reference.__name__.endswith(".lighttree")
    assert cell.limits == CELL.limits
    hook, undo = faults.plant(fault) if fault else (None, lambda: None)
    try:
        r = harness.run("tiny_tree.render", 2**31 + 21, 0.5, False, device="cpu", root=root,
                        traffic_hook=hook)
    finally:
        undo()
    assert r["correct"] is (fault is None), r["checks"]
    assert set(r["checks"]) == {"film_gap_p99", "film_count_gap"}
    assert not harness.forbidden_modules()
