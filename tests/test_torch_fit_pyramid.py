"""The port's pyramid fit (``fit --pyramid K``) against the plain reference
of its loss, ``benchmark/reference/pyramid.py``, float64 on the CPU: the
loss and every leaf's gradient, one Adam step of ``make_train_step``, the
blur counters and the profiler spans. The frame is 64×36, so both sides
are longer than the widest level's window (2·16 + 1); the parameters are
the default scene's, perturbed, and the target is random."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import fit as rfit
from benchmark.reference import pyramid as rpyr
from benchmark.reference import render as ref
from benchmark.reference.scene import load_scene
from benchmark.reference.stars import Sky
from benchmark.tests.helpers import write_catalogue
from blackstar_tpu_torch import fit as tfit
from blackstar_tpu_torch.config import Config, load_config, param_leaves, params_from_leaves
from blackstar_tpu_torch.stars.artifact import CELL_SIZE, K0, RADIUS
from blackstar_tpu_torch.stars.catalog import read_catalog
from blackstar_tpu_torch.stars.grid import build_star_grid_compact

W, H = 64, 36
LR = 0.01


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    stars = write_catalogue(str(tmp_path_factory.mktemp("sky") / "stars.ppm"))
    base = load_config("scenes/default.yaml")
    cfg = Config(scene=dataclasses.replace(base.scene, resolution=(W, H), dtype="float64"),
                 camera=base.camera)
    scene = dataclasses.replace(load_scene("scenes/default.yaml"), width=W, height=H)
    rng = np.random.default_rng(20)
    leaves = [v + 0.01 * v.abs() * torch.from_numpy(rng.normal(size=v.shape))
              for v in ref.scene_params(scene, "cpu", torch.float64).leaves()]
    target = torch.from_numpy(rng.uniform(0.0, 0.6, size=(H, W, 3)))
    grid = build_star_grid_compact(read_catalog(stars), cell_size=CELL_SIZE, radius=RADIUS,
                                   k0=K0).to_grid("cpu", dtype=torch.float64)
    return dict(scene=scene, static=cfg.static(), leaves=leaves, target=target, grid=grid,
                sky=Sky.from_ppm(stars, "cpu", torch.float64), cap=cfg.static().max_steps)


def _program_params(case):
    return params_from_leaves(v.clone() for v in case["leaves"])


@pytest.mark.parametrize("precomputed", [False, True], ids=["target", "levels"])
@pytest.mark.parametrize("pyramid", [1, 3])
def test_loss_and_grads_match_reference(case, pyramid, precomputed):
    """``image_loss`` and every leaf's gradient, with the target's levels
    blurred in the loss or passed from ``target_pyramid``, equal the
    reference's to rounding."""
    state = tfit.init_train_state(_program_params(case))
    target = tfit.target_pyramid(case["target"], pyramid) if precomputed else case["target"]
    loss = tfit.image_loss(state.params, case["static"], target, case["grid"], pyramid=pyramid)
    loss.backward()
    want, grads = rpyr.loss_and_grad(case["scene"], ref.Params.from_leaves(case["leaves"]),
                                     case["sky"], case["target"], cap=case["cap"],
                                     pyramid=pyramid)
    assert abs(float(loss.detach()) - float(want)) <= 1e-12 * float(want)
    scale = max(float(g.abs().max()) for g in grads)
    live = 0
    for (name, v), g in zip(param_leaves(state.params), grads):
        got = torch.zeros_like(g) if v.grad is None else v.grad
        assert float((got - g).abs().max()) <= 1e-9 * scale, name
        live += bool(g.abs().max() > 0)
    assert live == len(grads) - 1  # every leaf but the bloom strength (outside the loss)


def test_train_step_matches_reference_follow(case):
    """One ``make_train_step(pyramid=3)`` step, on the levels ``fit_scene``
    passes, takes the reference's Adam step: the same loss and change of
    every leaf."""
    state = tfit.init_train_state(_program_params(case), LR)
    step = tfit.make_train_step(case["static"], case["grid"], pyramid=3)
    state, loss = step(state, tfit.target_pyramid(case["target"], 3))
    r = rfit.follow(case["scene"], ref.Params.from_leaves(case["leaves"]), case["sky"],
                    case["target"], cap=case["cap"], steps=1, lr=LR,
                    loss=functools.partial(rpyr.loss_and_grad, pyramid=3))
    assert abs(float(loss) - r.losses[0]) <= 1e-12 * r.losses[0]
    for (name, v), start, change in zip(param_leaves(state.params), case["leaves"], r.change):
        assert float((v.detach() - start - change).abs().max()) <= 1e-9 * LR, name
    assert sum(bool(c.abs().max() > 0) for c in r.change) == len(r.change) - 1


def _small(case):
    """The fit's inputs at 16×9 and 24 steps a ray, for the counters and
    spans."""
    static = dataclasses.replace(case["static"], width=16, height=9, render_width=16,
                                 render_height=9, max_steps=24)
    return static, case["target"][:9, :16]


@pytest.mark.parametrize("pyramid", [0, 3])
def test_blur_counters(case, pyramid):
    """A job blurs the target once a level; a step blurs the rendered image
    once a level; a loss given a plain target blurs both; no pyramid, no
    blur."""
    static, target = _small(case)
    before = tfit.image_loss.pyramid_blurs, tfit.target_pyramid.blurs
    tfit.fit_scene(_program_params(case), static, target, case["grid"], steps=2,
                   learning_rate=LR, pyramid=pyramid)
    assert (tfit.image_loss.pyramid_blurs - before[0],
            tfit.target_pyramid.blurs - before[1]) == (2 * pyramid, pyramid)
    with torch.no_grad():
        tfit.image_loss(_program_params(case), static, target, case["grid"], pyramid=pyramid)
    assert (tfit.image_loss.pyramid_blurs - before[0],
            tfit.target_pyramid.blurs - before[1]) == (3 * pyramid, 2 * pyramid)


@pytest.mark.parametrize("pyramid", [0, 3])
def test_spans_under_the_profiler(case, pyramid):
    """``fit_scene`` records one ``fit.pyramid`` span a step and one
    ``fit.target_pyramid`` span a job, and none without a pyramid."""
    static, target = _small(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tfit.fit_scene(_program_params(case), static, target, case["grid"], steps=2,
                       learning_rate=LR, pyramid=pyramid)
    names = [e.name for e in prof.events()]
    expect = 1 if pyramid else 0
    assert (names.count("fit.pyramid"), names.count("fit.target_pyramid")) == \
        (2 * expect, expect)


@pytest.mark.parametrize("entry", ["image_loss", "fit_scene"])
def test_no_pyramid_never_blurs(case, monkeypatch, entry):
    """With ``pyramid=0`` neither the loss nor the fit calls a blur."""
    from blackstar_tpu_torch.ops import bloom_cuda, filters

    def refuse(*args, **kw):
        raise AssertionError("a blur ran without a pyramid")

    for owner, name in ((tfit, "pyramid_blur"), (filters, "pyramid_blur"),
                        (filters, "box_blur"), (bloom_cuda, "box_blur_cuda")):
        monkeypatch.setattr(owner, name, refuse)
    static, target = _small(case)
    if entry == "image_loss":
        params = tfit.init_train_state(_program_params(case)).params
        tfit.image_loss(params, static, target, case["grid"], pyramid=0).backward()
    else:
        tfit.fit_scene(_program_params(case), static, target, case["grid"], steps=2,
                       learning_rate=LR, pyramid=0)
