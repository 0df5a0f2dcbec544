"""The plain reference against the program's plain CPU path at tiny sizes
(float64, where both compute the same function to rounding), its star
search against a brute-force sum, its PNG reader against every row filter,
and the operation counts it derives."""

import dataclasses
import math
import struct
import zlib

import numpy as np
import pytest
import torch

from benchmark import workcount
from benchmark.pngread import read_png
from benchmark.reference import fit as rfit
from benchmark.reference import render as ref
from benchmark.reference.scene import (animation_camera, load_animation, load_scene, rotate_y,
                                       with_camera)
from benchmark.reference.stars import RADIUS, W, Sky, read_ppm
from benchmark.tests.helpers import write_catalogue
from blackstar_tpu_torch.config import Config, load_config, param_leaves
from blackstar_tpu_torch.fit import image_loss, init_train_state
from blackstar_tpu_torch.render import render_image
from blackstar_tpu_torch.stars.artifact import CELL_SIZE, K0, RADIUS as GRID_RADIUS
from blackstar_tpu_torch.stars.catalog import read_catalog
from blackstar_tpu_torch.stars.grid import build_star_grid_compact


@pytest.fixture(scope="module")
def stars(tmp_path_factory):
    return write_catalogue(str(tmp_path_factory.mktemp("sky") / "stars.ppm"))


def _program_grid(stars):
    return build_star_grid_compact(read_catalog(stars), cell_size=CELL_SIZE, radius=GRID_RADIUS,
                                   k0=K0).to_grid("cpu", dtype=torch.float64)


def _f64(cfg, w, h, camera=None):
    return Config(scene=dataclasses.replace(cfg.scene, resolution=(w, h), dtype="float64"),
                  camera=camera or cfg.camera)


@pytest.mark.parametrize("angle", [0.0, 137.0])
def test_still_matches_program_f64(stars, angle):
    """Rays, march, stars, composite and bloom of the default scene (bloom
    radius 2 at 64 px) equal the program's float64 CPU path to rounding."""
    from blackstar_tpu_torch.config import Camera

    sc = load_scene("scenes/default.yaml")
    sc = dataclasses.replace(sc, width=64, height=36)
    sc = with_camera(sc, rotate_y(sc.camera, angle))
    c = sc.camera
    cfg = _f64(load_config("scenes/default.yaml"), 64, 36,
               Camera(c.position, c.look_at, c.up, c.fov))
    program = render_image(cfg, _program_grid(stars), device="cpu")
    sky = Sky.from_ppm(stars, "cpu", torch.float64)
    mine, m = ref.render_linear(sc, ref.scene_params(sc, "cpu", torch.float64), sky,
                                cap=cfg.static().max_steps)
    assert (m.status == 1).any() and (m.status == 2).any()
    assert np.abs(program - mine.numpy()).max() < 1e-9


def test_animation_frame_matches_program_f64(stars):
    """A supersampled, bloomed frame of the example animation (its last
    keyframe's camera) equals the program's float64 CPU render."""
    from blackstar_tpu_torch.config import Camera

    anim = load_animation("animations/default-ani.yaml")
    cam = animation_camera(anim, anim.n_frames - 1)
    sc = dataclasses.replace(with_camera(anim.scene, cam), width=24, height=14)
    base = Config.from_dict({"scene": {"resolution": [24, 14], "bloomStrength": 0.7,
                                       "starIntensity": 0.7, "starSaturation": 0.7,
                                       "diskOpacity": 0.95, "diskInner": 1.8, "diskOuter": 13,
                                       "supersampling": True, "maxSteps": 617},
                             "camera": {"position": [0, 0, 1], "lookAt": [0, 0, 0],
                                        "upVec": [0, 1, 0], "fov": 1}})
    cfg = _f64(base, 24, 14, Camera(cam.position, cam.look_at, cam.up, cam.fov))
    program = render_image(cfg, _program_grid(stars), device="cpu")
    sky = Sky.from_ppm(stars, "cpu", torch.float64)
    mine, _ = ref.render_linear(sc, ref.scene_params(sc, "cpu", torch.float64), sky, cap=617)
    assert mine.shape == (14, 24, 3)
    assert np.abs(program - mine.numpy()).max() < 1e-9


def test_fit_gradient_matches_program_f64(stars):
    """The loss and every leaf's gradient equal the program's float64 CPU
    training path (B1's and B2's plain versions) to rounding."""
    sc = dataclasses.replace(load_scene("scenes/default.yaml"), width=24, height=14)
    cfg = _f64(load_config("scenes/default.yaml"), 24, 14)
    sky = Sky.from_ppm(stars, "cpu", torch.float64)
    cap = cfg.static().max_steps
    tsc = dataclasses.replace(sc, disk_outer=12.5, star_intensity=0.42)
    target, _ = ref.render_linear(tsc, ref.scene_params(tsc, "cpu", torch.float64), sky,
                                  cap=cap, with_bloom=False)
    state = init_train_state(cfg.params("cpu"))
    loss = image_loss(state.params, cfg.static(), target, _program_grid(stars))
    loss.backward()
    mine, grads = rfit.loss_and_grad(sc, ref.scene_params(sc, "cpu", torch.float64), sky,
                                     target, cap=cap)
    assert abs(float(loss.detach()) - float(mine)) <= 1e-12 * float(mine)
    scale = max(float(g.abs().max()) for g in grads)
    for (name, v), g in zip(param_leaves(state.params), grads):
        got = torch.zeros_like(g) if v.grad is None else v.grad
        assert float((got - g).abs().max()) <= 1e-9 * scale, name


def test_stars_match_brute_force(stars):
    """The cube search finds every star a brute-force sum over the whole
    catalogue finds, near stars and between them."""
    pos, mag, hue, sat = read_ppm(stars)
    rng = np.random.default_rng(3)
    near = pos[rng.integers(len(pos), size=300)] + rng.normal(scale=0.6 * RADIUS, size=(300, 3))
    far = rng.normal(size=(300, 3))
    dirs = np.concatenate([near, far])
    sky = Sky.from_ppm(stars, "cpu", torch.float64)
    got = sky.lookup(torch.tensor(dirs), torch.tensor(0.6, dtype=torch.float64),
                     torch.tensor(1.3, dtype=torch.float64)).numpy()
    want = np.zeros_like(dirs)
    for i, v in enumerate(dirs):
        n = v / np.linalg.norm(v)
        d2 = ((pos - n) ** 2).sum(-1)
        for j in np.nonzero(d2 <= RADIUS ** 2)[0]:
            val = 0.6 * min(1.0, math.exp(math.log(2) / 50 * (950 - mag[j]) - d2[j] / (2 * W * W)))
            t = lambda x: torch.tensor(x, dtype=torch.float64)
            rgb = ref.hsi_to_rgb(t(hue[j]), t(1.3 * sat[j]), t(val)).numpy()
            want[i] += rgb
    want = np.minimum(want, 1.0)
    assert (want > 0).any(axis=1).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def _png(rows, filters):
    """An RGB PNG whose row y is written with filter ``filters[y]``."""
    h, w, _ = rows.shape
    raw = b""
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        cur = rows[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        k = filters[y]
        if k == 0:
            f = cur
        elif k == 1:
            f = cur - left
        elif k == 2:
            f = cur - prev
        elif k == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = cur - pred
        raw += bytes([k]) + (f & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    chunk = lambda t, d: struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_reader_every_filter(tmp_path):
    rows = np.random.default_rng(1).integers(0, 256, size=(10, 7, 3)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png(rows, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]))
    np.testing.assert_array_equal(read_png(str(path)), rows)


def test_operation_counts():
    """The derived counts: 126 operations an RK4 step (4 accelerations of
    12, 36 for the stage points, 42 for the update), 5 more for the test on
    |p|², and the step's reverse as autograd computes it."""
    c = workcount.per_ray_step()
    assert c == {"B1": 131, "B2": 339, "rk4": 126, "rk4_backward": 213}
