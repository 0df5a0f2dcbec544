"""Scene and animation files read for the plain reference.

The upstream renderer's YAML schema (flannelhead/blackstar,
``src/ConfigFile.hs``): a ``camera`` (position, lookAt, upVec, fov) and a
``scene`` whose missing keys take the upstream defaults. The diskColor hue
is in degrees in the file and in [0, 1) here. An animation file has the
same ``scene``, ``nFrames`` and two or more camera ``keyframes`` at times
0 ... 1, interpolated linearly.

Nothing here imports the program: the reference reads the same files the
program reads, by its own parser.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import yaml

_DEFAULTS = dict(stepSize=0.3, bloomStrength=0.4, bloomDivider=25, starIntensity=0.7,
                 starSaturation=0.7, diskColor=(57.6, 0.1, 0.95), diskOpacity=0.0,
                 diskInner=3.0, diskOuter=12.0, resolution=(1280, 720), supersampling=False)

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class Camera:
    position: Vec3
    look_at: Vec3
    up: Vec3
    fov: float


@dataclass(frozen=True)
class Scene:
    camera: Camera
    width: int
    height: int
    supersampling: bool
    step: float
    bloom_strength: float
    bloom_divider: int
    star_intensity: float
    star_saturation: float
    disk_hsi: Vec3  # hue in [0, 1)
    disk_opacity: float
    disk_inner: float
    disk_outer: float
    mass: float = 1.0

    @property
    def render_size(self) -> Tuple[int, int]:
        """(width, height) of the rays: twice each side when supersampled."""
        k = 2 if self.supersampling else 1
        return self.width * k, self.height * k


@dataclass(frozen=True)
class Animation:
    scene: Scene
    n_frames: int
    keys: Tuple[Tuple[float, Camera], ...]


def camera_from_dict(d: dict) -> Camera:
    return Camera(tuple(float(v) for v in d["position"]), tuple(float(v) for v in d["lookAt"]),
                  tuple(float(v) for v in d["upVec"]), float(d["fov"]))


def scene_from_dict(d: dict, camera: Camera) -> Scene:
    s = {**_DEFAULTS, **(d or {})}
    h, sat, i = (float(v) for v in s["diskColor"])
    w, hgt = (int(v) for v in s["resolution"])
    return Scene(camera=camera, width=w, height=hgt, supersampling=bool(s["supersampling"]),
                 step=float(s["stepSize"]), bloom_strength=float(s["bloomStrength"]),
                 bloom_divider=int(s["bloomDivider"]),
                 star_intensity=float(s["starIntensity"]),
                 star_saturation=float(s["starSaturation"]), disk_hsi=(h / 360.0, sat, i),
                 disk_opacity=float(s["diskOpacity"]), disk_inner=float(s["diskInner"]),
                 disk_outer=float(s["diskOuter"]), mass=float(s.get("mass", 1.0)))


def scene_file(d: dict) -> Scene:
    """A scene file's contents (the YAML as a mapping)."""
    return scene_from_dict(d.get("scene"), camera_from_dict(d["camera"]))


def animation_file(d: dict) -> Animation:
    """An animation file's contents (the YAML as a mapping)."""
    keys = tuple(sorted(((float(k["time"]), camera_from_dict(k["camera"]))
                         for k in d["keyframes"]), key=lambda kv: kv[0]))
    return Animation(scene=scene_from_dict(d.get("scene"), keys[0][1]),
                     n_frames=int(d["nFrames"]), keys=keys)


def load_scene(path: str) -> Scene:
    with open(path) as f:
        return scene_file(yaml.safe_load(f))


def load_animation(path: str) -> Animation:
    with open(path) as f:
        return animation_file(yaml.safe_load(f))


def camera_dict(cam: Camera) -> dict:
    """The camera in the files' schema."""
    return {"position": list(cam.position), "lookAt": list(cam.look_at), "upVec": list(cam.up),
            "fov": cam.fov}


def animation_camera(anim: Animation, index: int) -> Camera:
    """Frame ``index``'s camera: keyframes interpolated linearly at
    ``t = index / (nFrames - 1)``, held past the last keyframe."""
    t = index / max(anim.n_frames - 1, 1)
    keys = anim.keys
    j = max(i for i, (kt, _) in enumerate(keys[:-1]) if kt <= t) if t >= keys[0][0] else 0
    (t1, a), (t2, b) = keys[j], keys[j + 1]
    u = min(max((t - t1) / (t2 - t1), 0.0), 1.0) if t2 > t1 else 0.0
    lerp = lambda x, y: tuple(xi + u * (yi - xi) for xi, yi in zip(x, y))
    return Camera(lerp(a.position, b.position), lerp(a.look_at, b.look_at), lerp(a.up, b.up),
                  a.fov + u * (b.fov - a.fov))


def rotate_y(cam: Camera, degrees: float) -> Camera:
    """The camera with its position, look-at point and up vector rotated
    together about the y axis (the disk's normal): the scene seen from
    another azimuth, the same distance from the hole."""
    c, s = math.cos(math.radians(degrees)), math.sin(math.radians(degrees))
    rot = lambda v: (c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2])
    return Camera(rot(cam.position), rot(cam.look_at), rot(cam.up), cam.fov)


def with_camera(scene: Scene, camera: Camera) -> Scene:
    return replace(scene, camera=camera)


def rotated_animation(anim: Animation, degrees: float) -> Animation:
    return replace(anim, keys=tuple((t, rotate_y(c, degrees)) for t, c in anim.keys))
