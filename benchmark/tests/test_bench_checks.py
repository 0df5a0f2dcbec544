"""The check that decides ``correct``, driven on the CPU at a tiny size:
the program passes it; the control (the reference in bfloat16 in the
program's place) fails it; and so does a run whose timed path is broken
underneath (a step or frame that returns its state unchanged, half of the
frame or batch left out, an answer altered where it is produced).

The harness's look for a card is skipped (``device="cpu"``); the rest of a
run is the benchmark's own, with the cell's own limits."""

import importlib

import pytest
import torch

from benchmark import control, harness
from benchmark.runners import common
from benchmark.runners.fit import fit_numbers
from benchmark.tests.helpers import TINY, overrides, write_catalogue


@pytest.fixture(scope="module")
def stars(tmp_path_factory):
    return write_catalogue(str(tmp_path_factory.mktemp("sky") / "stars.ppm"))


def run(workload, stars, seed=11, trace=False):
    return harness.run_cell(workload, seed, 0.05, trace, device="cpu",
                            overrides=overrides(workload, stars))


def over(r):
    return [k for k, c in r["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", ["default-1080p.frame", "default-ani.frames",
                                      "default-ani.png", "default-1080p.fit"])
def test_sound_run_is_correct(workload, stars):
    r = run(workload, stars)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(harness.load_cell(workload).limits)


def test_traced_run_checks_too(stars):
    r = run("default-1080p.frame", stars, trace=True)
    assert r["correct"] and "host_sync_ms.frame" in r["metrics"]
    assert r["device"]["window_s"] > 0 and r["breakdown"]["idle_gaps"]


# Faults planted under the timed path of the frame cells.

def _stale(orig):
    last = {}

    def f(*a, **k):
        out = orig(*a, **k)
        prev, last["img"] = last.get("img"), out
        return out if prev is None else prev

    return f


def _half(orig):
    def f(*a, **k):
        out = orig(*a, **k).clone()
        out[out.shape[0] // 2:] = 0
        return out

    return f


def _altered(orig):
    def f(*a, **k):
        out = orig(*a, **k).clone()
        h, w = out.shape[:2]
        out[: h // 3, : w // 3] += 0.25
        return out

    return f


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("workload,target", [("default-1080p.frame", "render_rgb"),
                                             ("default-ani.frames", "render"),
                                             ("default-ani.png", "render")])
def test_frame_fault_is_not_correct(workload, target, fault, stars, monkeypatch):
    R = importlib.import_module("blackstar_tpu_torch.render")
    monkeypatch.setattr(R, target, fault(getattr(R, target)))
    r = run(workload, stars, seed=23)
    assert not r["correct"] and over(r), r["checks"]


@pytest.mark.parametrize("workload", ["default-1080p.frame", "default-ani.frames"])
def test_control_fails_frames(workload, stars, monkeypatch):
    """The reference in bfloat16 against the float64 reference, on the
    frames a run draws, reads above a limit."""
    cell = harness.load_cell(workload)
    monkeypatch.setattr(common, "contents",
                        lambda c, size=None, _o=common.contents: _o(c, size or TINY))
    if workload.startswith("default-ani"):
        real = common.contents
        monkeypatch.setattr(common, "contents",
                            lambda c, size=None: dict(real(c, size), nFrames=4))
    monkeypatch.setattr(common, "stars_path", lambda c, s=None: stars)
    numbers = control.control_frames(cell, 5, torch.device("cpu"))
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


# Faults of the fit: planted in the program (torch.optim.Adam, fit.image_loss).

def test_fit_state_unchanged_is_not_correct(stars, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    r = run("default-1080p.fit", stars)
    assert not r["correct"] and {"first_change_gap", "median_grad_gap"} <= set(over(r)), r["checks"]


def _half_loss(orig):
    def f(params, static, target, *a, **k):
        from blackstar_tpu_torch.render import render

        img = render(params, static, a[0] if a else k.get("star_grid"), differentiable=True)
        rows = img.shape[0] // 2
        return torch.mean((img[:rows] - target[:rows].to(img.dtype)) ** 2)

    return f


def _altered_loss(orig):
    def f(*a, **k):
        return orig(*a, **k) * 1.05

    return f


@pytest.mark.parametrize("fault", [_half_loss, _altered_loss])
def test_fit_fault_is_not_correct(fault, stars, monkeypatch):
    F = importlib.import_module("blackstar_tpu_torch.fit")
    monkeypatch.setattr(F, "image_loss", fault(F.image_loss))
    r = run("default-1080p.fit", stars)
    assert not r["correct"] and over(r), r["checks"]


def test_control_fails_fit(stars, monkeypatch):
    cell = harness.load_cell("default-1080p.fit")
    real = common.contents
    monkeypatch.setattr(common, "contents", lambda c, size=None: real(c, size or TINY))
    monkeypatch.setattr(common, "stars_path", lambda c, s=None: stars)
    numbers = control.control_fit(cell, 5, torch.device("cpu"), "control")
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


def test_fit_numbers_of_an_unmoved_state():
    """A state left unchanged reads 1 on the change and the first gradient."""
    from benchmark.reference.fit import Followed

    g = [torch.tensor([3.0, 4.0]), torch.tensor(2.0), torch.tensor(0.0)]
    truth = Followed([1.0], g, [torch.tensor([0.01, 0.01]), torch.tensor(-0.01),
                                torch.tensor(0.0)])
    start = [torch.zeros(2, dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64),
             torch.tensor(0.0, dtype=torch.float64)]
    got = {"losses": [1.0], "m": [torch.zeros(2), torch.tensor(0.0), torch.tensor(0.0)],
           "params": [torch.zeros(2), torch.tensor(0.0), torch.tensor(0.0)]}
    n = fit_numbers(got, truth, start)
    assert n["median_grad_gap"] == pytest.approx(1.0)
    assert n["first_change_gap"] == pytest.approx(1.0) and n["first_loss_gap"] == 0.0
