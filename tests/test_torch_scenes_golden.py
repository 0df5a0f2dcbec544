"""The all-scenes gate for the port: every reference scene YAML
(``scenes/*.yaml``) rendered by ``blackstar_tpu_torch`` on the CPU in
float64, through the plain march, at reduced resolution, against the
scalar float64 oracle ``tests/oracle.py`` at atol 1e-7 with no truncated
ray; as ``tests/test_scenes_golden.py`` holds the JAX package. Geometry,
fov, disk and step size are verbatim from the scene files; only the
resolution changes, and ``bloomStrength`` is 0 (the oracle's render stops
before bloom).

The oracle's outputs are cached in ``tests/golden_cache`` under a key that
hashes the resolved scene and the oracle's source, as the JAX test caches
its 64-px goldens (the port's ``Config.to_dict`` is the JAX package's, so
both tests read the same files): an edit of the oracle or of a scene
misses the cache and recomputes."""

import dataclasses
import glob
import hashlib
import json
import os

import numpy as np
import pytest

from blackstar_tpu_torch.config import Config, load_config
from blackstar_tpu_torch.render import render
from tests import oracle

_HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = sorted(glob.glob(os.path.join(_HERE, "..", "scenes", "*.yaml")))
assert len(SCENES) == 9, SCENES
# The three disk-bearing scenes also run at 64 px: a 16-px grid under a
# wide fov samples the disk edge sparsely.
DISK_SCENES = [p for p in SCENES if os.path.basename(p) in
               ("default.yaml", "lensing-disk.yaml", "wideangle-disk.yaml")]
assert len(DISK_SCENES) == 3


def scene_at(path, width) -> Config:
    """The scene of ``path`` at ``width`` px wide (aspect kept), float64,
    bloom off."""
    cfg = load_config(path)
    w, h = cfg.scene.resolution
    scene = dataclasses.replace(cfg.scene, resolution=(width, max(2, width * h // w)),
                                dtype="float64", bloom_strength=0.0)
    return Config(scene=scene, camera=cfg.camera)


def golden_path(cfg: Config, path: str, width: int) -> str:
    """Where the oracle's render of ``cfg`` (the scene of ``path`` at
    ``width``) is cached."""
    with open(os.path.join(_HERE, "oracle.py"), "rb") as f:
        oracle_src = f.read()
    key_src = json.dumps(cfg.to_dict(), sort_keys=True).encode() + oracle_src
    key = hashlib.sha256(key_src).hexdigest()[:24]
    name = f"{os.path.basename(path).removesuffix('.yaml')}_{width}_{key}.npy"
    return os.path.join(_HERE, "golden_cache", name)


def oracle_golden(cfg: Config, path: str, width: int) -> np.ndarray:
    """The oracle's render of ``cfg``, from the cache or computed (and then
    cached)."""
    cache = golden_path(cfg, path, width)
    if os.path.exists(cache):
        return np.load(cache)
    want = oracle.render(cfg, None)
    np.save(cache, want)
    return want


def _check_scene(path, width):
    cfg = scene_at(path, width)
    got, stats = render(cfg.params("cpu"), cfg.static(), with_stats=True)
    assert float(stats.truncated_frac) == 0.0
    want = oracle_golden(cfg, path, width)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("path", SCENES, ids=[os.path.basename(p) for p in SCENES])
def test_scene_matches_oracle(path):
    _check_scene(path, 16)


@pytest.mark.parametrize("path", DISK_SCENES, ids=[os.path.basename(p) for p in DISK_SCENES])
def test_disk_scene_matches_oracle_medium_res(path):
    # The committed golden the JAX package's test reads.
    assert os.path.exists(golden_path(scene_at(path, 64), path, 64))
    _check_scene(path, 64)
