"""Readings that the limits of a pyramid fit cell are set from.

On the card, at the cell's own size::

    python3 -m benchmark.control_pyramid --workload default-1080p.fit-pyramid3 \\
        --seeds 1,2,3 [--seconds 2] [--control-seeds 7,8,9] \\
        [--faults half,altered,dropped]

``--seeds`` gives the program's readings as :mod:`benchmark.control` does
for any cell. For each of ``--control-seeds`` the reference takes the
checked step in the program's place, with the pyramid loss
(:mod:`benchmark.reference.pyramid`), and its numbers against the float64
reference are printed: ``control``, the reference computed in bfloat16;
and the planted faults ``half`` (the loss over half of the frame's rows),
``altered`` (the loss reported 5% high) and ``dropped`` (the pyramid
dropped: the loss with no blurred level). Every reading is a JSON line on
standard output.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch

from benchmark import control
from benchmark.harness import load_cell
from benchmark.reference import fit as rfit
from benchmark.reference import pyramid as rpyr
from benchmark.reference import render as ref
from benchmark.runners import common
from benchmark.runners.fit import fit_inputs, fit_numbers


def half_rows_loss(scene, p, sky, target, *, cap, pyramid):
    """The pyramid loss over the first half of the frame's rows alone, and
    its gradients."""
    leaves = [v.detach().clone().requires_grad_(True) for v in p.leaves()]
    img, _ = ref.render_linear(scene, ref.Params.from_leaves(leaves), sky, cap=cap, grad=True,
                               with_bloom=False)
    rows = img.shape[0] // 2
    loss = rpyr.pyramid_loss(img[:rows], target[:rows], pyramid)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]


def control_fit(cell, seed: int, device, kind: str) -> dict:
    """The pyramid fit's numbers with the reference in the program's place:
    ``control`` computed in bfloat16, or a planted fault at float64."""
    t = cell.traffic
    k = int(t["pyramid"])
    loss = functools.partial(rpyr.loss_and_grad, pyramid=k)
    _, scene, tscenes = fit_inputs(cell, seed)
    hi = common.ReferenceFrames(cell, device, torch.float64)
    target = hi.linear(tscenes[0], with_bloom=False).float()  # the checked job's target
    follow, lr = int(t["follow_steps"]), float(t["lr"])
    p64 = ref.scene_params(scene, device, torch.float64)
    run = lambda p, frames, fn: rfit.follow(scene, p, frames.sky, target, cap=frames.cap,
                                            steps=follow, lr=lr, loss=fn)
    truth = run(p64, hi, loss)
    if kind == "control":
        lo = common.ReferenceFrames(cell, device, torch.bfloat16)
        p16 = ref.scene_params(scene, device, torch.bfloat16)
        got = control._as_program(run(p16, lo, loss), p16, follow)
        got = {"losses": got["losses"], "m": [m.double() for m in got["m"]],
               "params": [v.double() for v in got["params"]]}
        return fit_numbers(got, truth, [v.double() for v in p16.leaves()])
    faults = {"half": functools.partial(half_rows_loss, pyramid=k),
              "dropped": functools.partial(rpyr.loss_and_grad, pyramid=0)}
    if kind in faults:
        return fit_numbers(control._as_program(run(p64, hi, faults[kind]), p64, follow), truth,
                           p64.leaves())
    if kind == "altered":
        got = control._as_program(truth, p64, follow)
        got["losses"] = [1.05 * x for x in got["losses"]]
        return fit_numbers(got, truth, p64.leaves())
    raise ValueError(f"unknown fault {kind!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("control_pyramid: needs a CUDA card")
    if args.seeds:
        control.main(["--workload", args.workload, "--seeds", args.seeds,
                      "--seconds", str(args.seconds)])
    device = torch.device("cuda:0")
    cell = load_cell(args.workload)
    for seed in [int(x) for x in args.control_seeds.split(",") if x]:
        for kind in ["control"] + [k for k in args.faults.split(",") if k]:
            t0 = time.time()
            numbers = control_fit(cell, seed, device, kind)
            torch.cuda.empty_cache()
            print(json.dumps({"kind": kind, "seed": seed, "seconds": time.time() - t0,
                              "numbers": numbers}), flush=True)


if __name__ == "__main__":
    main()
