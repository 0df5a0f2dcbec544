"""N-process check of the sharded renderer: sharded equals unsharded.

The port of ``scripts/multihost_check.py``. It launches N processes (default
2) joined by ``torch.distributed`` through a ``file://`` store in a fresh
temporary directory (no fixed port, so runs side by side never meet), each
renders the scene sharded over all of them (``parallel.render_sharded``),
and rank 0 holds the sharded image against the unsharded ``render`` it
computes itself. ``--grad`` adds the sharded training step: its parameter
gradients (summed over the ranks by one all-reduce) and the parameters after
two Adam steps against the unsharded step's. Every run also checks the
gather's backward: each rank's shard gradient is its rows of the image
gradient, not N times them.

The scene is ``scenes/default.yaml`` at 64×36 in float64, without bloom.
Each rank runs on ``cuda:LOCAL_RANK`` with NCCL (the default), or with
``--backend gloo`` when the ranks share one card (NCCL refuses two ranks on
one device); ``--device cpu`` runs them on the CPU over gloo, each on one
thread::

    python -m blackstar_tpu_torch.scripts.multihost_check                  # 2 cards
    python -m blackstar_tpu_torch.scripts.multihost_check --backend gloo   # 2 ranks, 1 card
    python -m blackstar_tpu_torch.scripts.multihost_check --device cpu --ranks 3 --grad

It ends with "multi-host check passed" when every sharded image is within
1e-12 of the unsharded one and every gradient within rtol 1e-9 of it.
:func:`launch` runs the workers on a list of cases (``name``; ``config``,
a scene as ``Config.from_dict`` reads it; optional ``starmap``, ``grad``,
``target``: scene overrides for the training target (default: seeded
noise), ``ref64``: also the unsharded float64 step, ``time_reps``: warm
frame times, sharded and unsharded) and saves rank 0's results
(``torch.save``): the tests and ``chip_smoke.py`` drive it so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GRAD_RTOL = 1e-9  # the sharded gradient against the unsharded one, floor 1e-12·max


def counters() -> dict:
    """Kernel launches and plain-version calls so far in this process."""
    from blackstar_tpu_torch import geodesic
    from blackstar_tpu_torch.ops.march_adjoint_cuda import march_adjoint_cuda
    from blackstar_tpu_torch.ops.march_cuda import march_cuda
    from blackstar_tpu_torch.ops.march_vjp import (march_adjoint_from_checkpoints,
                                                   march_adjoint_reference)
    from blackstar_tpu_torch.stars.grid import StarGrid
    from blackstar_tpu_torch.stars.lookup_cuda import star_lookup_cuda, star_lookup_vjp_cuda

    return {"b1": march_cuda.launches, "b2": march_adjoint_cuda.launches,
            "b3": star_lookup_cuda.launches, "b4": star_lookup_vjp_cuda.launches,
            "plain": (geodesic.march.calls + march_adjoint_reference.calls
                      + march_adjoint_from_checkpoints.calls + StarGrid.lookup.calls
                      + StarGrid.lookup_vjp.calls)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, reps, dev) -> float:
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _target(cfg, case, grid, dev):
    """The training target, the same on every rank: the scene rendered with
    the case's ``target`` overrides (before bloom), or seeded noise."""
    from blackstar_tpu_torch.config import Config
    from blackstar_tpu_torch.render import render

    static = cfg.static()
    if case.get("target"):
        tcfg = Config(scene=dataclasses.replace(cfg.scene, **case["target"]), camera=cfg.camera)
        with torch.no_grad():
            return render(tcfg.params(dev), tcfg.static(), grid)
    rng = np.random.default_rng(3)
    shape = (static.height, static.width, 3)
    return torch.from_numpy(rng.uniform(0.0, 0.6, size=shape)).to(dev, static.tdtype)


def _train(params, static, grid, target, mesh, steps=2):
    """Losses, the first step's leaf gradients and the leaves after
    ``steps`` Adam steps (lr 1e-2), sharded over ``mesh`` or not."""
    from blackstar_tpu_torch.config import param_leaves
    from blackstar_tpu_torch.fit import init_train_state, make_train_step

    state = init_train_state(params, 1e-2)
    step = make_train_step(static, grid, mesh=mesh)
    losses, grads = [], None
    for _ in range(steps):
        state, loss = step(state, target)
        losses.append(float(loss))
        if grads is None:
            grads = {n: v.grad.detach().cpu().clone() for n, v in param_leaves(state.params)
                     if v.grad is not None}
    leaves = {n: v.detach().cpu().clone() for n, v in param_leaves(state.params)}
    return {"losses": losses, "grads": grads, "params": leaves}


def _gather_backward_ok(mesh) -> bool:
    """The gather's backward on a 13-row frame: this rank's shard gradient
    equals its rows of the image gradient (0 on the padded rows)."""
    from blackstar_tpu_torch.parallel.render import BAND_ROWS, GatherShards, shard_rows

    h, w = 13, 5
    rows = shard_rows(h, mesh)
    n_bands = -(-h // BAND_ROWS)
    per = -(-n_bands // mesh.size)
    unclamped = ((mesh.rank + mesh.size * torch.arange(per))[:, None] * BAND_ROWS
                 + torch.arange(BAND_ROWS)).reshape(-1)
    shard = (rows[:, None] * w + torch.arange(w)).to(mesh.device, torch.float64)
    shard = shard.reshape(-1, 1).repeat(1, 3).requires_grad_(True)
    gw = torch.from_numpy(np.random.default_rng(5).normal(size=(h, w, 3))).to(mesh.device)
    img = GatherShards.apply(shard, mesh, h, w)
    (img * gw).sum().backward()
    want = torch.zeros(rows.numel(), w, 3, dtype=torch.float64, device=mesh.device)
    keep = unclamped < h
    want[keep] = gw[unclamped[keep]]
    values_ok = torch.equal(img[:, :, 0].cpu(), (torch.arange(h)[:, None] * w
                                                 + torch.arange(w)).double())
    return values_ok and torch.equal(shard.grad, want.reshape(-1, 3))


def worker(rank: int, world: int, init_file: str, spec_path: str, device: str,
           backend) -> None:
    """One rank: every case of the spec, sharded; rank 0 also unsharded, and
    it writes the results (``spec["out"]``)."""
    torch.set_num_threads(1)
    os.environ.setdefault("LOCAL_RANK", str(rank))
    from blackstar_tpu_torch.config import Config
    from blackstar_tpu_torch.parallel import initialize_distributed, make_mesh, render_sharded
    from blackstar_tpu_torch.render import render
    from blackstar_tpu_torch.stars.grid import load_star_grid_compact

    with open(spec_path) as f:
        spec = json.load(f)
    initialize_distributed(f"file://{init_file}", world, rank, backend, device=device)
    mesh = make_mesh(device)
    dev = mesh.device
    dist = torch.distributed
    compact = {}

    def grid_for(case, dtype):
        path = case.get("starmap")
        if not path:
            return None
        if path not in compact:
            compact[path] = load_star_grid_compact(path)
        return compact[path].to_grid(dev, dtype=dtype)

    results = {"world": world, "device": str(dev), "backend": dist.get_backend(),
               "gather_backward_ok": None, "cases": {}}
    for case in spec["cases"]:
        cfg = Config.from_dict(case["config"])
        params, static = cfg.params(dev), cfg.static()
        grid = grid_for(case, static.tdtype)
        target = _target(cfg, case, grid, dev) if case.get("grad") else None
        before = counters()
        img = render_sharded(params, static, grid, mesh=mesh)
        sharded = _train(params, static, grid, target, mesh) if case.get("grad") else None
        _sync(dev)
        counts = {k: v - before[k] for k, v in counters().items()}
        out = {"img": img.cpu(), "counts": [None] * world}
        dist.all_gather_object(out["counts"], counts)
        reps = case.get("time_reps", 0)
        if reps:
            out["sharded_ms"] = _wall_ms(lambda: render_sharded(params, static, grid, mesh=mesh),
                                         reps, dev)
        if rank == 0:
            out["ref"] = render(params, static, grid).cpu()
            if reps:
                out["unsharded_ms"] = _wall_ms(lambda: render(params, static, grid), reps, dev)
            if sharded is not None:
                out["train"] = sharded
                out["ref_train"] = _train(params, static, grid, target, None)
                if case.get("ref64"):
                    cfg64 = Config(scene=dataclasses.replace(cfg.scene, dtype="float64"),
                                   camera=cfg.camera)
                    out["ref64_train"] = _train(cfg64.params(dev), cfg64.static(),
                                                grid_for(case, torch.float64), target.double(),
                                                None, steps=1)
            results["cases"][case["name"]] = out
        del grid, img
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()  # the others wait while rank 0 works alone
    oks = [None] * world
    dist.all_gather_object(oks, _gather_backward_ok(mesh))
    results["gather_backward_ok"] = oks
    if rank == 0 and spec.get("out"):
        torch.save(results, spec["out"])
    dist.destroy_process_group()


def launch(spec: dict, ranks: int, device: str = "cuda", backend=None, timeout: float = 600,
           out=None) -> int:
    """Run the workers on ``spec`` in ``ranks`` processes; their exit code
    (nonzero if any failed; every process is ended before this returns)."""
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(dict(spec, out=out), f)
        cmd = [sys.executable, "-m", "blackstar_tpu_torch.scripts.multihost_check", "_worker",
               "--spec", spec_path, "--init", os.path.join(tmp, "rendezvous"),
               "--ranks", str(ranks), "--device", device] + (["--backend", backend]
                                                              if backend else [])
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env)
                 for r in range(ranks)]
        deadline = time.monotonic() + timeout
        try:
            # A rank that fails leaves the others waiting in a collective:
            # stop at the first failure (or at the deadline: 124).
            while True:
                rcs = [p.poll() for p in procs]
                failed = [rc for rc in rcs if rc]
                if failed or all(rc == 0 for rc in rcs):
                    return failed[0] if failed else 0
                if time.monotonic() > deadline:
                    return 124
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def check(results: dict, atol: float) -> list:
    """Rank 0's results against the unsharded ones: the failures, as text."""
    from blackstar_tpu_torch.config import LEAF_PATHS

    failed = []
    if not all(results["gather_backward_ok"]):
        failed.append(f"gather backward per rank {results['gather_backward_ok']}")
    for name, out in results["cases"].items():
        err = (out["img"] - out["ref"]).abs().max().item()
        line = f"  {name}: sharded vs unsharded max |d| {err:.3g}"
        if err > atol:
            failed.append(f"{name}: image max |d| {err:.3g} > {atol}")
        if "train" in out:
            for leaf in ("." + p for p in LEAF_PATHS):
                g, r = out["train"]["grads"].get(leaf), out["ref_train"]["grads"].get(leaf)
                if (g is None) != (r is None):
                    failed.append(f"{name}: {leaf} has a gradient on one side only")
                elif g is not None and not torch.allclose(
                        g, r, rtol=GRAD_RTOL, atol=1e-12 * r.abs().max().item()):
                    failed.append(f"{name}: {leaf} gradient off by "
                                  f"{(g - r).abs().max().item():.3g}")
            line += (f"; losses {out['train']['losses']} vs {out['ref_train']['losses']}")
        print(line)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="", help=argparse.SUPPRESS)
    ap.add_argument("--ranks", type=int, default=2, help="processes (default 2)")
    ap.add_argument("--device", default="cuda", help="cuda (default: cuda:LOCAL_RANK) or cpu")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: the device's)")
    ap.add_argument("--grad", action="store_true", help="also the sharded training step")
    ap.add_argument("--spec", default="", help=argparse.SUPPRESS)
    ap.add_argument("--init", default="", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mode == "_worker":
        worker(args.rank, args.ranks, args.init, args.spec, args.device, args.backend)
        return 0

    import yaml

    with open(os.path.join(ROOT, "scenes", "default.yaml")) as f:
        scene = yaml.safe_load(f)
    scene["scene"].update(resolution=[64, 36], dtype="float64", bloomStrength=0.0)
    spec = {"cases": [{"name": "default.yaml", "config": scene, "grad": args.grad}]}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.pt")
        rc = launch(spec, args.ranks, args.device, args.backend, 600, out)
        if rc:
            print(f"multi-host check failed: a worker exited with {rc}")
            return rc
        results = torch.load(out)
    failed = check(results, atol=1e-12)
    if failed:
        print("multi-host check FAILED:\n  " + "\n  ".join(failed))
        return 1
    print(f"multi-host check passed: {args.ranks} processes ({results['backend']} on "
          f"{results['device']} for rank 0), sharded == unsharded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
