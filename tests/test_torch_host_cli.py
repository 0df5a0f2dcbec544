"""Port parity for the host surface on the CPU: the animate CLI (YAML
expansion against the JAX CLI's files, ``--render --device cpu``), the
render CLI's ``--shard-scenes``, ``--profile`` and batch writer pool, the
dispatcher, and ``debug.checked_render``."""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from blackstar_tpu.cli.animate import main as janimate_main
from blackstar_tpu.cli.render import main as jrender_main
from blackstar_tpu_torch import debug, video
from blackstar_tpu_torch.__main__ import main as dispatch_main
from blackstar_tpu_torch.animation import load_animation
from blackstar_tpu_torch.cli.animate import main as animate_main
from blackstar_tpu_torch.cli.render import main as render_main
from blackstar_tpu_torch.config import Config, load_config, param_leaves, params_from_leaves
from blackstar_tpu_torch.imageio import read_png
from blackstar_tpu_torch.render import render
from blackstar_tpu_torch.stars.catalog import Catalog, spectral_color
from blackstar_tpu_torch.stars.grid import build_star_grid_compact, save_star_grid

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANIM = os.path.join(_ROOT, "animations", "default-ani.yaml")


def _write_animation(path, n_frames=3, **scene):
    anim = {
        "scene": {"resolution": [12, 7], "diskOpacity": 0.9, "maxSteps": 60,
                  "bloomStrength": 0.2, "dtype": "float32", **scene},
        "nFrames": n_frames,
        "interpolation": "linear",
        "keyframes": [
            {"time": 0, "camera": {"position": [0, 1, -20], "lookAt": [0, 0, 0],
                                   "upVec": [0, 1, 0], "fov": 1.5}},
            {"time": 1, "camera": {"position": [5, 1, -20], "lookAt": [0, 0, 0],
                                   "upVec": [0, 1, 0], "fov": 2.0}},
        ],
    }
    with open(path, "w") as f:
        yaml.safe_dump(anim, f)


def _tiny_scenes(dirpath, **scene):
    """The nine reference scenes' names, each a tiny float32 scene with the
    same static settings (so the JAX CLI compiles one render)."""
    os.makedirs(dirpath, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(_ROOT, "scenes", "*.yaml"))):
        cfg = load_config(path)
        d = {"camera": cfg.camera.to_dict(),
             "scene": {"resolution": [8, 5], "maxSteps": 60, "bloomStrength": 0.0,
                       "diskOpacity": 0.9, "dtype": "float32", **scene}}
        with open(os.path.join(dirpath, os.path.basename(path)), "w") as f:
            yaml.safe_dump(d, f)


@pytest.fixture(scope="module")
def star_map(tmp_path_factory):
    """A small seeded star grid file (400 stars)."""
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(400, 3))
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    chars = rng.choice(list("OBAFGKM"), 400)
    cat = Catalog(pos=pos, mag=rng.integers(300, 1200, 400).astype(np.int32),
                  hue=np.array([spectral_color(c)[0] for c in chars]),
                  sat=np.array([spectral_color(c)[1] for c in chars]))
    grid = build_star_grid_compact(cat, cell_size=0.05, radius=0.06, k0=4)
    return save_star_grid(grid, str(tmp_path_factory.mktemp("stars") / "stars.grid"))


def test_animate_yaml_expansion_matches_jax_cli(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert animate_main([_ANIM, "-o", str(ours), "-f"]) == 0
    assert janimate_main([_ANIM, "-o", str(theirs), "-f"]) == 0
    names = sorted(os.listdir(ours))
    assert len(names) == 375 and names == sorted(os.listdir(theirs))
    assert names[0] == "default-ani_000.yaml" and names[-1] == "default-ani_374.yaml"
    for name in names:
        a, b = (ours / name).read_text(), (theirs / name).read_text()
        assert yaml.safe_load(a) == yaml.safe_load(b), name
        assert a == b, name


def test_animate_checks_its_input(tmp_path, capsys):
    assert animate_main([str(tmp_path / "absent.yaml")]) == 1
    bad = tmp_path / "bad.yaml"
    _write_animation(bad)
    d = yaml.safe_load(bad.read_text())
    d["keyframes"][1]["time"] = 0.5
    bad.write_text(yaml.safe_dump(d))
    assert animate_main([str(bad), "-o", str(tmp_path / "o"), "--render", "--device", "cpu"]) == 1
    assert "time == 1" in capsys.readouterr().out


def test_animate_render_on_the_cpu(tmp_path, star_map, capsys):
    anim_path = tmp_path / "orbit.yaml"
    _write_animation(anim_path)
    out = tmp_path / "frames"
    assert animate_main([str(anim_path), "-o", str(out), "--render", "--device", "cpu",
                         "--starmap", star_map]) == 0
    log = capsys.readouterr().out
    assert "PNG writer: native pool" in log and "Rendered 3 frames" in log
    assert sorted(os.listdir(out)) == ["orbit_0.png", "orbit_1.png", "orbit_2.png"]
    # The same pixels as render_animation with the same grid.
    from blackstar_tpu_torch.stars.grid import load_star_grid

    grid = load_star_grid(star_map, "cpu", dtype=torch.float32)
    want = video.render_animation(load_animation(str(anim_path)), str(tmp_path / "direct"),
                                  star_grid=grid, basename="orbit", device="cpu")
    for w in want:
        np.testing.assert_array_equal(read_png(str(out / os.path.basename(w))), read_png(w))
    # -f is checked up front: the frames exist now.
    assert animate_main([str(anim_path), "-o", str(out), "--render", "--device", "cpu",
                         "--starmap", star_map]) == 1
    assert "already exist" in capsys.readouterr().out


def test_animate_render_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card error cannot occur")
    anim_path = tmp_path / "orbit.yaml"
    _write_animation(anim_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        animate_main([str(anim_path), "-o", str(tmp_path / "f"), "--render", "-f",
                      "--starmap", str(tmp_path / "absent.npz")])
    assert not os.path.exists(tmp_path / "f" / "orbit_0.png")


def test_render_shard_scenes_matches_jax_cli(tmp_path):
    scenes = tmp_path / "scenes"
    _tiny_scenes(scenes)
    for shard in ("1/3", "0/2"):
        ours, theirs = tmp_path / f"port{shard[0]}", tmp_path / f"jax{shard[0]}"
        absent = str(tmp_path / "absent.npz")
        assert render_main([str(scenes), "-o", str(ours), "-f", "--device", "cpu",
                            "--shard-scenes", shard, "--starmap", absent]) == 0
        assert jrender_main([str(scenes), "-o", str(theirs), "-f", "--shard-scenes", shard,
                             "--starmap", absent]) == 0
        names = sorted(os.listdir(ours))
        assert names == sorted(os.listdir(theirs))
        i, n = (int(v) for v in shard.split("/"))
        assert names == [os.path.basename(p)[:-5] + ".png"
                         for p in sorted(glob.glob(str(scenes / "*.yaml")))][i::n]


@pytest.mark.parametrize("shard", ["3/3", "-1/2", "1/0", "x", "1/2/3"])
def test_render_bad_shard_exits_2(tmp_path, shard):
    scenes = tmp_path / "scenes"
    _tiny_scenes(scenes)
    assert render_main([str(scenes), "-o", str(tmp_path / "o"), "-f", "--device", "cpu",
                        f"--shard-scenes={shard}", "--starmap", str(tmp_path / "absent")]) == 2


def test_render_profile_writes_a_trace(tmp_path):
    scenes = tmp_path / "scenes"
    _tiny_scenes(scenes)
    prof = tmp_path / "prof"
    assert render_main([str(scenes / "default.yaml"), "-o", str(tmp_path / "o"), "-f",
                        "--device", "cpu", "--profile", str(prof),
                        "--starmap", str(tmp_path / "absent")]) == 0
    (trace,) = os.listdir(prof)
    with open(prof / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_render_batch_pool_equals_single_renders(tmp_path, star_map):
    scenes = tmp_path / "scenes"
    _tiny_scenes(scenes, bloomStrength=0.3, starIntensity=0.9)
    batch, single = tmp_path / "batch", tmp_path / "single"
    assert render_main([str(scenes), "-o", str(batch), "-f", "--device", "cpu",
                        "--starmap", star_map]) == 0
    names = sorted(os.listdir(batch))
    assert len(names) == 9
    for name in names:
        assert render_main([str(scenes / (name[:-4] + ".yaml")), "-o", str(single),
                            "--device", "cpu", "--starmap", star_map]) == 0
        np.testing.assert_array_equal(read_png(str(batch / name)), read_png(str(single / name)))


def test_dispatcher_lists_and_runs_the_commands(tmp_path, capsys):
    assert dispatch_main(["--help"]) == 0
    usage = capsys.readouterr().out
    assert all(c in usage for c in ("render", "animate", "generate-grid", "fit"))
    assert dispatch_main(["nope"]) == 2
    anim_path = tmp_path / "orbit.yaml"
    _write_animation(anim_path, n_frames=2)
    assert dispatch_main(["animate", str(anim_path), "-o", str(tmp_path / "y")]) == 0
    assert sorted(os.listdir(tmp_path / "y")) == ["orbit_0.yaml", "orbit_1.yaml"]


def _debug_cfg():
    d = {"camera": {"position": [0, 1, -20], "lookAt": [0, 0, 0], "upVec": [0, 1, 0],
                    "fov": 1.5},
         "scene": {"resolution": [8, 5], "dtype": "float64", "diskOpacity": 0.9,
                   "supersampling": True}}
    return Config.from_dict(d)


def test_checked_render_passes_a_clean_scene(star_map):
    from blackstar_tpu_torch.stars.grid import load_star_grid

    cfg = _debug_cfg()
    grid = load_star_grid(star_map, "cpu", dtype=torch.float64)
    got = debug.checked_render(cfg.params("cpu"), cfg.static(), grid)
    want = render(cfg.params("cpu"), cfg.static(), grid)
    assert got.shape == (5, 8, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("leaf,stage", [("camera.position", "rays"), ("mass", "march"),
                                        ("stars.intensity", "stars")])
def test_checked_render_names_the_stage_of_a_nan(star_map, leaf, stage):
    from blackstar_tpu_torch.stars.grid import load_star_grid

    cfg = _debug_cfg()
    names, leaves = zip(*((n, v.clone()) for n, v in param_leaves(cfg.params("cpu"))))
    leaves[names.index("." + leaf)].view(-1)[0] = float("nan")
    params = params_from_leaves(leaves)
    grid = load_star_grid(star_map, "cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match=f"after the {stage} stage"):
        debug.checked_render(params, cfg.static(), grid)
