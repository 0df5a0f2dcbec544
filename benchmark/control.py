"""Readings that the limits of ``limits/<workload>.json`` are set from.

On the card, at the cell's own size::

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \\
        [--seconds 2] [--control-seeds 7,8,9] [--faults half,altered]

For each of ``--seeds`` it runs the cell as the benchmark does (set-up, a
short window of ``--seconds``, the reference's check) and prints the numbers
compared: the program's readings, whose largest is a limit's lower end. For
each of ``--control-seeds`` it puts the reference, computed in bfloat16
(the precision below the configuration's float32), in the program's place
and prints the same numbers against the float64 reference: the control,
whose smallest is a limit's upper end. ``--faults`` reads a training
cell's planted faults the same way (the reference in the program's place):
``half``, the loss over half of the frame's rows; ``altered``, the loss
reported 5% high. Every reading is a JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from benchmark.runners import common
from benchmark.runners.fit import BETA1, fit_inputs, fit_numbers
from benchmark.harness import load_cell, run_cell
from benchmark.reference import fit as rfit
from benchmark.reference import render as ref
from benchmark.reference.scene import (animation_camera, animation_file, rotate_y,
                                       rotated_animation, scene_file, with_camera)


def frame_scenes(cell, seed: int):
    """The scenes a run of ``seed`` could check: ``check_frames`` of them,
    at angles (and animation frames) drawn from the seed."""
    rng = np.random.default_rng(seed)
    k = int(cell.traffic["check_frames"])
    d = common.contents(cell)
    if cell.config["kind"] == "scene":
        s = scene_file(d)
        return [with_camera(s, rotate_y(s.camera, float(rng.uniform(0, 360)))) for _ in range(k)]
    anim = animation_file(d)
    out = []
    for _ in range(k):
        rot = rotated_animation(anim, float(rng.uniform(0, 360)))
        out.append(with_camera(anim.scene, animation_camera(rot, int(rng.integers(anim.n_frames)))))
    return out


def control_frames(cell, seed: int, device) -> dict:
    hi = common.ReferenceFrames(cell, device, torch.float64)
    lo = common.ReferenceFrames(cell, device, torch.bfloat16)
    numbers = [common.frame_numbers(lo.rgb8(s), hi.rgb8(s)) for s in frame_scenes(cell, seed)]
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def _as_program(r, p0, follow: int) -> dict:
    """What the fit runner captures of a program's job, from the reference
    run in the program's place."""
    return {"losses": r.losses[:follow], "m": [(1 - BETA1) * g for g in r.first_grad],
            "params": [a + d for a, d in zip(p0.leaves(), r.change)]}


def control_fit(cell, seed: int, device, kind: str) -> dict:
    """The fit's numbers with the reference in the program's place:
    ``control`` computed in bfloat16, or a planted fault at float64."""
    t = cell.traffic
    _, scene, tscenes = fit_inputs(cell, seed)
    tscene = tscenes[0]  # the target of a run's first job, the one checked
    hi = common.ReferenceFrames(cell, device, torch.float64)
    target = hi.linear(tscene, with_bloom=False).float()
    follow, lr = int(t["follow_steps"]), float(t["lr"])
    p64 = ref.scene_params(scene, device, torch.float64)
    truth = rfit.follow(scene, p64, hi.sky, target, cap=hi.cap, steps=follow, lr=lr)
    if kind == "control":
        lo = common.ReferenceFrames(cell, device, torch.bfloat16)
        p16 = ref.scene_params(scene, device, torch.bfloat16)
        r = rfit.follow(scene, p16, lo.sky, target, cap=lo.cap, steps=follow, lr=lr)
        got = _as_program(r, p16, follow)
        got = {"losses": got["losses"], "m": [m.double() for m in got["m"]],
               "params": [v.double() for v in got["params"]]}
        return fit_numbers(got, truth, [v.double() for v in p16.leaves()])
    if kind == "half":
        r = rfit.follow(scene, p64, hi.sky, target, cap=hi.cap, steps=follow, lr=lr,
                        loss=half_rows_loss)
        return fit_numbers(_as_program(r, p64, follow), truth, p64.leaves())
    if kind == "altered":
        got = _as_program(truth, p64, follow)
        got["losses"] = [1.05 * x for x in got["losses"]]
        return fit_numbers(got, truth, p64.leaves())
    raise ValueError(f"unknown fault {kind!r}")


def half_rows_loss(scene, p, sky, target, *, cap):
    """The loss over the first half of the frame's rows alone, and its
    gradients: half of the batch left out, the mean over the rest."""
    leaves = [v.detach().clone().requires_grad_(True) for v in p.leaves()]
    img, _ = ref.render_linear(scene, ref.Params.from_leaves(leaves), sky, cap=cap, grad=True,
                               with_bloom=False)
    rows = img.shape[0] // 2
    loss = torch.mean((img[:rows] - target[:rows].to(img.dtype)) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("control: needs a CUDA card")
    device = torch.device("cuda:0")
    cell = load_cell(args.workload)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    seeds = lambda s: [int(x) for x in s.split(",") if x]
    for seed in seeds(args.seeds):
        t0 = time.time()
        r = run_cell(args.workload, seed, args.seconds, False, t_start=t0)
        emit({"kind": "program", "seed": seed, "seconds": time.time() - t0,
              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
              "numbers": {k: v["value"] for k, v in r["checks"].items()}})
    kinds = ["control"] + [k for k in args.faults.split(",") if k]
    for seed in seeds(args.control_seeds):
        for kind in kinds:
            t0 = time.time()
            if cell.traffic["runner"] == "fit":
                numbers = control_fit(cell, seed, device, kind)
            elif kind == "control":
                numbers = control_frames(cell, seed, device)
            else:
                raise SystemExit(f"control: no fault {kind!r} for a frame cell")
            torch.cuda.empty_cache()
            emit({"kind": kind, "seed": seed, "seconds": time.time() - t0, "numbers": numbers})


if __name__ == "__main__":
    main()
