"""The plain references that decide ``correct``: plain PyTorch, nothing of the port.

A configuration file names its reference under ``reference``: a module
``<reference>.py`` of this folder, ``integrator`` where it names none
(``harness.reference_module``). The harness loads this folder as a
package of its own, once a process, and hands the module to every part
of a run that needs the reference, so a configuration whose estimator
differs (textures, a light tree, another sampler) brings a module of its
own here as a new file. A reference module provides:

- ``SAMPLERS``: the configuration's ``sampler`` → a factory ``(seed,
  dtype=torch.float32)`` of the sampler the functions below take.
  ``harness.reference_module`` refuses, before set-up, a configuration
  whose ``sampler`` is not a key; ``check.render_numbers``,
  ``check.reference_steps`` and ``harness.reckon`` call the factory.
- ``make_scene(spec, device, dtype=torch.float32)``: the scene builder's
  spec as the reference's scene. It has ``v0``, ``e0`` and ``e1``, (T, 3)
  tensors of each triangle's first corner and two edges, over which
  ``harness.reckon`` walks the benchmark's own BVH (``work.py``) and whose
  ``v0.device`` ``check`` reads; for a ``grad`` mix also
  ``materials.albedo``, the parameter ``check.reference_steps`` starts its
  own Adam from.
- ``Work(keep_rays=True)``: what traced paths needed, counted as they are
  traced: ``paths``, ``closest_rays``, ``hits``, ``shadow_rays``,
  ``shadow_tests``, and the rays of the queries, ``closest`` [(o, d)] and
  ``shadow`` [(o, d, t_max)]. ``harness.reckon`` reads every field; the
  roofline shares count their work from it.
- ``pixel_samples(scene, sampler, px, py, sample0, nspp, max_depth,
  work=None)``: the radiance (nspp, P, 3) of samples sample0 .. sample0 +
  nspp - 1 of pixels (px, py), counted into ``work`` where one is given
  (``harness.reckon``, at one sample).
- ``film_batch(scene, sampler, px, py, sample0, kspp, spp_per_pass,
  max_depth, before=None)``: one progressive batch into the film
  ``before`` (mean, m2, n) or an empty one → ((mean, m2, n), the batch's
  own mean), for ``render`` mixes (``check.render_numbers``).
- ``image_loss(scene, sampler, albedo, sample0, spp, width, height,
  max_depth, target)``: the L2 image loss with the materials' albedo
  replaced by the leaf ``albedo``, as a float, with ``albedo.grad``
  filled, for ``grad`` mixes (``check.reference_steps``).

Every one works in float32, and in bfloat16 for the control (``control.py``
through ``check``'s ``control``). A reference module imports plain
PyTorch and NumPy and, by relative imports, modules of this folder: nothing
of the port, of JAX, or of the rest of ``pt_bench``
(``test_reference_imports_nothing_of_the_port``).
"""
