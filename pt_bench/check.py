"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference, the module of ``pt_bench/reference`` that the
cell's configuration names (``harness.reference_module``), which works
everything out again from the benchmark's own scene spec.

Render cells. The window's answers are its progressive films. The window's
first batch (from an empty film) and ``check_batches`` more drawn from the
seed are checked, each at ``check_pixels`` pixels drawn from the seed: the
reference traces every sample of the batch at those pixels and folds them
into the film the batch started from (the first batch: its own empty
film; a later one: the program's film before it, the one stage the
reference follows from the program's state), then

- ``film_gap_p99``: the 99th percentile, over the checked pixel values,
  of the gap between the program's film after the batch and the
  reference's, scaled to the batch's own mean (times n / kspp), over the
  reference's batch mean plus the mean of those (a relative gap, with
  the image's mean as the floor of dark pixels);
- ``film_count_gap``: the largest gap between the program film's sample
  count and the count before the batch plus kspp (exact).

Gradient cell. Set-up drives the step (loss, backward, Adam) from the seed
through its first three steps; the reference follows them from its own
albedo with its own Adam, then

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_norm_gap``: the relative gap of the first gradient's norm, the
  program's read from its optimiser state after one step;
- ``step_norm_gap``: the relative gap of the norm of the parameters'
  change after the three steps.

With ``control`` the same numbers are computed for the reference in
bfloat16 put in the program's place.
"""

from __future__ import annotations

import math

import torch

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def check_pixels(seed: int, index: int, width: int, height: int, count: int, device):
    """``count`` distinct pixels of a batch, drawn from (seed, batch index)."""
    g = torch.Generator().manual_seed((int(seed) * 1_000_003 + index) % (1 << 63))
    idx = torch.randperm(width * height, generator=g)[:count].sort().values.to(device)
    return idx % width, idx // width


def _gaps(after_mean, after_n, ref_mean, batch_mean, kspp):
    scale = float(after_n) / kspp
    d = (after_mean.double() - ref_mean.double()).abs() * scale
    b = batch_mean.double().abs()
    return (d / (b + b.mean())).flatten()


def _reference_batches(reference, ref_scene, sampler, batches, cfg, mix, seed):
    """The reference's film after each checked batch at its pixels →
    [(px, py, (mean, m2, n), batch mean)]."""
    out = []
    for j, (sample0, before, after) in enumerate(batches):
        px, py = check_pixels(seed, j, cfg["width"], cfg["height"], mix["check_pixels"],
                              ref_scene.v0.device)
        start = None if before is None else tuple(
            x[py, px] for x in (before.mean, before.m2)) + (before.n,)
        film, bmean = reference.film_batch(ref_scene, sampler, px, py, sample0, mix["kspp"],
                                           mix["spp_per_pass"], cfg["max_depth"], before=start)
        out.append((px, py, film, bmean))
    return out


def render_numbers(reference, spec, cfg, mix, seed, batches, device,
                   control: bool = False) -> dict:
    """The render cell's numbers against the ``reference`` module for the
    checked ``batches`` [(sample0, film before or None, film after)]; with
    ``control`` for that reference in bfloat16 in the program's place."""
    sampler = reference.SAMPLERS[cfg["sampler"]]
    ref = reference.make_scene(spec, device)
    refs = _reference_batches(reference, ref, sampler(seed), batches, cfg, mix, seed)
    if control:
        low = reference.make_scene(spec, device, torch.bfloat16)
        lows = _reference_batches(reference, low, sampler(seed, torch.bfloat16), batches, cfg,
                                  mix, seed)
    gaps, count_gap = [], 0.0
    for j, ((px, py, film, bmean), (sample0, before, after)) in enumerate(zip(refs, batches)):
        if control:
            got_mean, got_n = lows[j][2][0], float(lows[j][2][2])
        else:
            got_mean, got_n = after.mean[py, px], float(after.n)
        n0 = 0.0 if before is None else float(before.n)
        count_gap = max(count_gap, abs(got_n - (n0 + mix["kspp"])))
        gaps.append(_gaps(got_mean, got_n, film[0], bmean, mix["kspp"]))
    g = torch.cat(gaps)
    return {"film_gap_p99": float(torch.quantile(g.float(), 0.99)),
            "film_gap_max": float(g.max()), "film_count_gap": count_gap}


def _adam(p, g, m, v, t, lr):
    b1, b2 = ADAM_BETAS
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    mhat = m / (1.0 - b1**t)
    vhat = v / (1.0 - b2**t)
    return p - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS), m, v


def reference_steps(reference, spec, cfg, mix, seed, device, dtype=torch.float32,
                    steps: int = 3):
    """The ``reference`` module's first ``steps`` steps from its own albedo
    → (losses, first gradient, parameters before, parameters after)."""
    scene = reference.make_scene(spec, device, dtype)
    sampler = reference.SAMPLERS[cfg["sampler"]](seed, dtype)
    p = scene.materials.albedo.clone()
    p0 = p.clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    losses, g1 = [], None
    for k in range(steps):
        leaf = p.detach().clone().requires_grad_(True)
        loss = reference.image_loss(scene, sampler, leaf, k * mix["spp"], mix["spp"],
                                    cfg["width"], cfg["height"], cfg["max_depth"], mix["target"])
        g = leaf.grad.detach()
        g1 = g if g1 is None else g1
        losses.append(loss)
        p, m, v = _adam(p, g, m, v, k + 1, mix["lr"])
    return losses, g1, p0, p


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b != 0.0 else (0.0 if a == 0.0 else math.inf)


def grad_numbers(reference, spec, cfg, mix, seed, got, device, control: bool = False) -> dict:
    """The gradient cell's numbers against the ``reference`` module for the
    program's readings ``got`` (losses, first gradient, parameters before,
    parameters after); with ``control`` for that reference in bfloat16 in
    the program's place."""
    steps = len(got[0])
    r_loss, r_g1, r_p0, r_p3 = reference_steps(reference, spec, cfg, mix, seed, device,
                                               steps=steps)
    if control:
        got = reference_steps(reference, spec, cfg, mix, seed, device, torch.bfloat16,
                              steps=steps)
    p_loss, p_g1, p_p0, p_p3 = got
    norm = lambda x: float(torch.linalg.vector_norm(x.double()))  # noqa: E731
    return {
        "loss_gap": max(_rel(a, b) for a, b in zip(p_loss, r_loss)),
        "grad_norm_gap": _rel(norm(p_g1), norm(r_g1)),
        "step_norm_gap": _rel(norm(p_p3.double() - p_p0.double()), norm(r_p3 - r_p0)),
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that has a limit beside it → (all within, {name:
    {value, limit}}); the others are readings only (``control.py``)."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values()), out
