"""Keyframe animation: camera interpolation across frames.

The port of ``blackstar_tpu/animation.py``, which mirrors the reference
(``src/Animation.hs``):

* ``Animation{scene, nFrames, interpolation, keyframes}`` where each keyframe
  is ``{camera, time}`` with normalised time in [0, 1] (Animation.hs:15-24).
* Validation: at least two keyframes, the first at time 0 and the last at
  time 1 (Animation.hs:38-43).
* Frame k of nFrames samples ``t = k/(nFrames-1)``; keyframes are sorted by
  time; camera position/lookAt/upVec/fov are piecewise-linearly interpolated
  between the bracketing keyframes (half-open brackets ``t1 <= t < t2``, the
  final keyframe extended past t = 1 so the last frame lands exactly on it,
  Animation.hs:45-79). ``linear`` is the only interpolation method (unknown
  strings fall back to it, Animation.hs:29-34).
* The scene block is constant across frames (Animation.hs:54-59).

:func:`camera_at` gives the interpolation as a tensor function of time that
autograd differentiates; ``video.render_animation`` renders from it on the
device without a YAML round-trip per frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch
import yaml

from blackstar_tpu_torch.config import Camera, CameraParams, Config, Scene


@dataclass
class Keyframe:
    camera: Camera
    time: float

    @classmethod
    def from_dict(cls, d: dict) -> "Keyframe":
        return cls(camera=Camera.from_dict(d["camera"]), time=float(d["time"]))

    def to_dict(self) -> dict:
        return {"camera": self.camera.to_dict(), "time": self.time}


@dataclass
class Animation:
    scene: Scene
    n_frames: int
    interpolation: str
    keyframes: List[Keyframe]

    @classmethod
    def from_dict(cls, d: dict) -> "Animation":
        if "nFrames" not in d:
            raise ValueError("animation config is missing the required "
                             "'nFrames' key")
        return cls(
            scene=Scene.from_dict(d.get("scene", {})),
            n_frames=int(d["nFrames"]),
            # Unknown methods fall back to linear (Animation.hs:29-34).
            interpolation="linear",
            keyframes=[Keyframe.from_dict(k) for k in d.get("keyframes", [])],
        )


def load_animation(path: str) -> Animation:
    with open(path) as f:
        d = yaml.safe_load(f)
    if not isinstance(d, dict):
        raise ValueError(f"{path}: expected a YAML mapping at top level")
    return Animation.from_dict(d)


def validate_keyframes(keyframes: Sequence[Keyframe]) -> None:
    """Raise ValueError on invalid keyframes (Animation.hs:38-43)."""
    if len(keyframes) < 2:
        raise ValueError("Must have at least two keyframes")
    if keyframes[0].time != 0.0 or keyframes[-1].time != 1.0:
        raise ValueError("First keyframe must have time == 0, last time == 1")


def _lerp_camera(c1: Camera, c2: Camera, t: float) -> Camera:
    def lv(a, b):
        return tuple(ai + t * (bi - ai) for ai, bi in zip(a, b))

    return Camera(
        position=lv(c1.position, c2.position),
        look_at=lv(c1.look_at, c2.look_at),
        up=lv(c1.up, c2.up),
        fov=c1.fov + t * (c2.fov - c1.fov),
    )


def interpolate(keyframes: Sequence[Keyframe], t: float) -> Camera:
    """Camera at normalised time ``t`` (Animation.hs:61-79).

    Keyframes must be sorted by time. Bracketing is half-open
    (``t1 <= t < t2``); past the last keyframe the camera holds constant
    (the reference extends the final keyframe by one time unit).
    """
    frames = list(keyframes)
    for f1, f2 in zip(frames, frames[1:]):
        if f1.time <= t < f2.time:
            local = (t - f1.time) / (f2.time - f1.time)
            return _lerp_camera(f1.camera, f2.camera, local)
    last = frames[-1]
    # findFrames [fr] = (fr, fr{time+1}): local t' = (t - t_last) / 1.
    return _lerp_camera(last.camera, last.camera, t - last.time)


def generate_frames(anim: Animation) -> List[Config]:
    """Expand an animation to per-frame Configs (Animation.hs:45-59)."""
    frames = sorted(anim.keyframes, key=lambda k: k.time)
    # Validated here, not only in the CLI: before the first keyframe the
    # reference's interpolate falls through to the *last* keyframe while
    # camera_at clamps to the first, so keyframes that do not span [0, 1]
    # would make the two paths disagree.
    validate_keyframes(frames)
    step = 1.0 / (anim.n_frames - 1) if anim.n_frames > 1 else 0.0
    return [
        Config(scene=anim.scene, camera=interpolate(frames, k * step))
        for k in range(anim.n_frames)
    ]


def camera_times(keyframes: Sequence[Keyframe]):
    """(times, positions, look_ats, ups, fovs) float64 arrays of the
    keyframes sorted by time."""
    frames = sorted(keyframes, key=lambda k: k.time)
    t = np.array([k.time for k in frames], np.float64)
    pos = np.array([k.camera.position for k in frames], np.float64)
    lat = np.array([k.camera.look_at for k in frames], np.float64)
    up = np.array([k.camera.up for k in frames], np.float64)
    fov = np.array([k.camera.fov for k in frames], np.float64)
    return t, pos, lat, up, fov


def camera_at(keyframes: Sequence[Keyframe], t: torch.Tensor) -> CameraParams:
    """Camera interpolation at the times ``t`` (a tensor), differentiable
    in ``t``.

    Returns a :class:`CameraParams` whose leaves have ``t``'s leading
    shape (position (..., 3), fov (...)), dtype and device. Before the
    first keyframe the camera is the first keyframe's, past the last the
    last keyframe's (the bracket index and the local time are clamped).
    """
    kt, pos, lat, up, fov = (torch.as_tensor(a, dtype=t.dtype, device=t.device)
                             for a in camera_times(keyframes))
    # Bracket index: largest i with kt[i] <= t, clamped to the last segment.
    i = torch.clamp(torch.searchsorted(kt, t.detach(), right=True) - 1, 0, kt.shape[0] - 2)
    t1, t2 = kt[i], kt[i + 1]
    span = t2 - t1
    local = torch.where(span > 0, (t - t1) / torch.where(span > 0, span, torch.ones_like(span)),
                        torch.zeros_like(t))
    # Hold past the final keyframe like the reference.
    local = torch.clamp(local, 0.0, 1.0)

    def lerp(a):
        lo, hi = a[i], a[i + 1]
        return lo + (local[..., None] if a.ndim > 1 else local) * (hi - lo)

    return CameraParams(position=lerp(pos), look_at=lerp(lat), up=lerp(up), fov=lerp(fov))


def pad_zero(max_val: int, val: int) -> str:
    """Zero-pad ``val`` to the digit count of ``max_val`` (Util.hs:43-48)."""
    n_digits = lambda x: int(math.floor(math.log10(x))) + 1 if x > 0 else 1
    return "0" * (n_digits(max_val) - n_digits(val)) + str(val)


def frame_filename(basename: str, n_frames: int, idx: int) -> str:
    """``<base>_<paddedIdx>.yaml`` (app/Animate.hs:53-56)."""
    return f"{basename}_{pad_zero(n_frames - 1, idx)}.yaml"
