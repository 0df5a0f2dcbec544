"""Port parity: sharded rendering over ``torch.distributed`` on the CPU.

The port's ``camera.generate_rays_at`` against the JAX package's and
against its own unsharded rays; ``parallel.render_sharded`` on 2 and 3 gloo
ranks (``scripts/multihost_check.py``, one thread a process) against the
unsharded port render and the JAX package's ``render_sharded`` on its 8
virtual CPU devices; the sharded training step's gradients and Adam steps
against the single-process port and ``jax.grad`` of JAX's sharded loss; the
gather's backward; and the ``--sharded`` CLIs on a 1-rank group against
the unsharded CLIs. Float64 at small sizes."""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from blackstar_tpu import fit as jfit
from blackstar_tpu.camera import generate_rays_at as j_generate_rays_at
from blackstar_tpu.config import Config as JConfig
from blackstar_tpu.parallel.mesh import make_mesh as j_make_mesh
from blackstar_tpu.parallel.render import render_sharded as j_render_sharded
from blackstar_tpu.stars.grid import build_star_grid as j_build_star_grid
from blackstar_tpu_torch import config as tconfig
from blackstar_tpu_torch import geodesic, video
from blackstar_tpu_torch.animation import load_animation
from blackstar_tpu_torch.camera import generate_ray_components, generate_rays, generate_rays_at
from blackstar_tpu_torch.cli.animate import main as animate_main
from blackstar_tpu_torch.cli.fit import main as fit_main
from blackstar_tpu_torch.cli.render import main as render_main
from blackstar_tpu_torch.imageio import encode_rgb8, write_png
from blackstar_tpu_torch.parallel import RAY_AXIS, initialize_distributed, make_mesh
from blackstar_tpu_torch.render import render, safe_distance
from blackstar_tpu_torch.scripts import multihost_check
from blackstar_tpu_torch.stars.catalog import Catalog
from blackstar_tpu_torch.stars.grid import build_star_grid_compact, save_star_grid

CAMERA = {"position": [0, 1, -20], "lookAt": [2, 0, 0], "upVec": [-0.2, 1, 0], "fov": 1.5}
DISK = {"diskOpacity": 0.95, "diskInner": 1.8, "diskOuter": 13.0}


def _scene(res, **scene):
    return {"camera": dict(CAMERA),
            "scene": {"resolution": list(res), "dtype": "float64", "maxSteps": 300,
                      "bloomStrength": 0.0, **scene}}


# The cases the ranks render: disk on with a seeded sky on a ragged 13x7
# frame (no band deal of 2 or 3 ranks divides it), which they also train on;
# and a supersampled frame (the deal at 16x12, the average after the gather).
CASES = {
    "ragged_disk_stars": dict(config=_scene((13, 7), starIntensity=0.8,
                                            starSaturation=0.6, **DISK), stars=True, grad=True),
    "supersampled": dict(config=_scene((8, 6), supersampling=True, **DISK)),
}
GRID = dict(cell_size=0.05, radius=0.06, k0=4)  # a small grid: the JAX lookup compiles fast
RANKS = (2, 3)


def _sky():
    """Stars near (perturbed) escaped-ray directions of the star cases'
    frames, so the PSF query hits (numpy seed)."""
    dirs = []
    for case in CASES.values():
        if not case.get("stars"):
            continue
        cfg = tconfig.Config.from_dict(case["config"])
        params, static = cfg.params("cpu"), cfg.static()
        pos, vel = generate_rays(params.camera, static.width, static.height, torch.float64)
        res = geodesic.march(pos, vel, params, static, safe_distance(params, torch.float64))
        dirs.append(res.vel[res.status == geodesic.ESCAPED].numpy())
    esc = np.concatenate(dirs)
    esc /= np.linalg.norm(esc, axis=-1, keepdims=True)
    rng = np.random.default_rng(11)
    pos = np.repeat(esc, 2, axis=0) + 5e-4 * rng.normal(size=(2 * len(esc), 3))
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    return Catalog(pos=pos, mag=rng.integers(600, 1100, len(pos)).astype(np.int32),
                   hue=np.full(len(pos), 0.094), sat=np.full(len(pos), 0.29))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded runs on 2 and 3 ranks (started first, in the
    background) and the JAX package's sharded renders and gradients."""
    tmp = tmp_path_factory.mktemp("sharded")
    cat = _sky()
    starmap = save_star_grid(build_star_grid_compact(cat, **GRID), str(tmp / "stars.grid"))
    spec = {"cases": [{"name": name, "config": c["config"], "grad": c.get("grad", False),
                       "starmap": starmap if c.get("stars") else None}
                      for name, c in CASES.items()]}
    with concurrent.futures.ThreadPoolExecutor(len(RANKS)) as pool:
        futures = {n: pool.submit(multihost_check.launch, spec, n, "cpu", None, 240,
                                  str(tmp / f"ranks{n}.pt")) for n in RANKS}
        jgrid = j_build_star_grid(cat, dtype=jnp.float64, **GRID)
        mesh = j_make_mesh(jax.devices()[:8])
        jax_out = {}
        for name, c in CASES.items():
            jcfg = JConfig.from_dict(c["config"])
            params, static = jcfg.params(), jcfg.static()
            g = jgrid if c.get("stars") else None
            jax_out[name] = {"img": np.asarray(j_render_sharded(params, static, g, mesh=mesh))}
            if c.get("grad"):
                target = jnp.asarray(_target(c["config"]))
                grads = jax.jit(jax.grad(lambda p: jfit.image_loss(
                    p, static, target, g, mesh=mesh)))(params)
                jax_out[name]["grads"] = jax.tree.map(np.asarray, grads)
        rcs = {n: f.result() for n, f in futures.items()}
    assert rcs == {n: 0 for n in RANKS}, rcs
    return {"jax": jax_out,
            "port": {n: torch.load(str(tmp / f"ranks{n}.pt")) for n in RANKS}}


def _target(config):
    """multihost_check's default training target (seeded noise)."""
    res = config["scene"]["resolution"]
    return np.random.default_rng(3).uniform(0.0, 0.6, size=(res[1], res[0], 3))


# ---- camera.generate_rays_at ------------------------------------------------

@pytest.mark.parametrize("size", [(16, 9), (13, 7), (64, 36)])
def test_generate_rays_at_matches_jax(size):
    w, h = size
    jcfg = JConfig.from_dict(_scene(size))
    tparams = tconfig.Config.from_dict(_scene(size)).params("cpu")
    ids = np.random.default_rng(w * h).choice(w * h, size=min(w * h, 50), replace=False)
    jpos, jdirs = j_generate_rays_at(jcfg.params().camera, jnp.asarray(ids), w, h,
                                     dtype=jnp.float64)
    pos, planes = generate_rays_at(tparams.camera, torch.from_numpy(ids), w, h, torch.float64)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-15)
    np.testing.assert_allclose(torch.stack(planes, dim=-1).numpy(), np.asarray(jdirs),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generate_rays_at_equals_the_frame_rays_bit_for_bit(dtype):
    """Any subset, in any order, repeats allowed: the bits of
    generate_ray_components for those pixels (a sharded f32 frame then
    equals the unsharded one)."""
    w, h = 37, 23
    params = tconfig.Config.from_dict(_scene((w, h))).params("cpu")
    pos, planes = generate_ray_components(params.camera, w, h, dtype)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, w * h, size=400))
    pos_at, planes_at = generate_rays_at(params.camera, ids, w, h, dtype)
    assert torch.equal(pos_at, pos)
    for full, sub in zip(planes, planes_at):
        assert sub.dtype == dtype and torch.equal(sub, full[ids])


# ---- render_sharded on gloo ranks -------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_render_matches_unsharded_and_jax(runs, ranks, name):
    out = runs["port"][ranks]["cases"][name]
    assert runs["port"][ranks]["world"] == ranks
    cfg = tconfig.Config.from_dict(CASES[name]["config"])
    assert out["img"].shape == (cfg.static().height, cfg.static().width, 3)
    np.testing.assert_allclose(out["img"].numpy(), out["ref"].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["img"].numpy(), runs["jax"][name]["img"], rtol=0, atol=1e-12)
    if CASES[name].get("stars"):  # the sky is lit in the frame
        bare = render(cfg.params("cpu"), cfg.static())
        assert (out["img"] - bare).abs().max() > 1e-3
    # Every rank rendered through the plain versions on the CPU.
    for counts in out["counts"]:
        assert counts["plain"] > 0 and counts["b1"] == counts["b3"] == 0


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_gradients_match_unsharded_and_jax(runs, ranks):
    out = runs["port"][ranks]["cases"]["ragged_disk_stars"]
    got, ref = out["train"]["grads"], out["ref_train"]["grads"]
    jgrads = dict(tconfig.param_leaves(tconfig.params_from_numpy(runs["jax"]["ragged_disk_stars"]["grads"],
                                                                 "cpu")))
    assert set(got) == set(ref) and len(got) >= 9
    for leaf, g in got.items():
        for want in (ref[leaf], jgrads[leaf]):
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-8, atol=1e-12,
                                       err_msg=leaf)
    assert out["train"]["losses"][0] == pytest.approx(out["ref_train"]["losses"][0], rel=1e-12)


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_adam_steps_equal_unsharded(runs, ranks):
    out = runs["port"][ranks]["cases"]["ragged_disk_stars"]
    for leaf, v in out["train"]["params"].items():
        torch.testing.assert_close(v, out["ref_train"]["params"][leaf], rtol=1e-12, atol=1e-15,
                                   msg=leaf)
    np.testing.assert_allclose(out["train"]["losses"], out["ref_train"]["losses"], rtol=1e-12)
    assert out["train"]["losses"][1] < out["train"]["losses"][0]


@pytest.mark.parametrize("ranks", RANKS)
def test_gather_backward_is_the_image_gradient_not_ranks_times_it(runs, ranks):
    assert runs["port"][ranks]["gather_backward_ok"] == [True] * ranks


# ---- the process group ------------------------------------------------------

def test_backend_follows_the_device_and_a_group_is_needed(tmp_path):
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh("cpu")
    with pytest.raises(ValueError, match="torchrun"):
        initialize_distributed(world_size=2, rank=1, device="cpu")
    initialize_distributed(device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        mesh = make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.device, RAY_AXIS) == (
            0, 1, torch.device("cpu"), "rays")
    finally:
        dist.destroy_process_group()
    initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo", device="cpu")
    try:
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


# ---- --sharded CLIs on a 1-rank group ---------------------------------------

def _write_scene(path, **scene):
    d = _scene((12, 7), **DISK)
    d["scene"].update({"dtype": "float32", "bloomStrength": 0.2, **scene})
    with open(path, "w") as f:
        yaml.safe_dump(d, f)


def test_render_cli_sharded_writes_the_unsharded_png(tmp_path):
    scene = tmp_path / "small.yaml"
    _write_scene(scene)
    for sub, extra in (("plain", []), ("sharded", ["--sharded", "--stats"])):
        assert render_main([str(scene), "-o", str(tmp_path / sub), "-f", "--device", "cpu",
                            "--starmap", str(tmp_path / "none.npz")] + extra) == 0
    assert not dist.is_initialized()  # the CLI left the group it joined
    with open(tmp_path / "plain" / "small.png", "rb") as a, \
            open(tmp_path / "sharded" / "small.png", "rb") as b:
        assert a.read() == b.read()


def test_fit_cli_sharded_writes_the_unsharded_files(tmp_path):
    scene, target = tmp_path / "small.yaml", tmp_path / "target.png"
    _write_scene(scene, bloomStrength=0.0, dtype="float64")
    tcfg = tconfig.load_config(str(scene))
    tcfg = dataclasses.replace(tcfg, scene=dataclasses.replace(tcfg.scene, disk_outer=12.0))
    write_png(encode_rgb8(render(tcfg.params("cpu"), tcfg.static())).numpy(), str(target))
    for sub, extra in (("plain", []), ("sharded", ["--sharded"])):
        os.makedirs(tmp_path / sub)
        assert fit_main([str(scene), str(target), "--fit", "disk.outer", "--steps", "2",
                         "--lr", "0.05", "--device", "cpu", "-f", "-o",
                         str(tmp_path / sub / "fitted.yaml"), "--checkpoint",
                         str(tmp_path / sub / "ck.npz")] + extra) == 0
    assert not dist.is_initialized()
    with open(tmp_path / "plain" / "fitted.yaml", "rb") as a, \
            open(tmp_path / "sharded" / "fitted.yaml", "rb") as b:
        assert a.read() == b.read()
    with np.load(tmp_path / "plain" / "ck.npz") as a, np.load(tmp_path / "sharded" / "ck.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_animate_cli_sharded_writes_the_unsharded_frames(tmp_path):
    anim = {"scene": {"resolution": [12, 7], "diskOpacity": 0.9, "maxSteps": 60,
                      "bloomStrength": 0.2, "dtype": "float32"},
            "nFrames": 3, "interpolation": "linear",
            "keyframes": [{"time": 0, "camera": {"position": [0, 1, -20], "lookAt": [0, 0, 0],
                                                 "upVec": [0, 1, 0], "fov": 1.5}},
                          {"time": 1, "camera": {"position": [5, 1, -20], "lookAt": [0, 0, 0],
                                                 "upVec": [0, 1, 0], "fov": 2.0}}]}
    path = tmp_path / "orbit.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(anim, f)
    for sub, extra in (("plain", []), ("sharded", ["--sharded"])):
        assert animate_main([str(path), "-o", str(tmp_path / sub), "--render", "-f",
                             "--device", "cpu", "--starmap", str(tmp_path / "none.npz")]
                            + extra) == 0
    assert not dist.is_initialized()
    names = sorted(os.listdir(tmp_path / "plain"))
    assert names == ["orbit_0.png", "orbit_1.png", "orbit_2.png"]
    assert sorted(os.listdir(tmp_path / "sharded")) == names
    for name in names:
        with open(tmp_path / "plain" / name, "rb") as a, open(tmp_path / "sharded" / name,
                                                              "rb") as b:
            assert a.read() == b.read(), name


def test_video_frames_sharded_on_one_rank_equal_unsharded(tmp_path):
    anim_path = tmp_path / "a.yaml"
    with open(anim_path, "w") as f:
        yaml.safe_dump({"scene": {"resolution": [9, 5], "maxSteps": 60, "diskOpacity": 0.9,
                                  "dtype": "float32"},
                        "nFrames": 2, "interpolation": "linear",
                        "keyframes": [{"time": 0, "camera": CAMERA},
                                      {"time": 1, "camera": dict(CAMERA, fov=1.8)}]}, f)
    anim = load_animation(str(anim_path))
    want = [rgb8.copy() for _, rgb8 in video.frames(anim, device="cpu")]
    initialize_distributed(device="cpu")
    try:
        got = [rgb8.copy() for _, rgb8 in video.frames(anim, device="cpu", sharded=True)]
    finally:
        dist.destroy_process_group()
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
