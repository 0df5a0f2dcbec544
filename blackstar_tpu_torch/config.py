"""Scene / camera configuration layer.

YAML schema, field names, and defaults mirror the reference
(its ``src/ConfigFile.hs:16-84``) and the JAX package's
``blackstar_tpu/config.py``:

* ``Scene``: stepSize=0.3, bloomStrength=0.4, bloomDivider=25,
  starIntensity=0.7, starSaturation=0.7, diskColor=HSI(0.16,0.1,0.95)
  (YAML hue is degrees and is divided by 360 at parse, ConfigFile.hs:48-54),
  diskOpacity=0, diskInner=3, diskOuter=12, resolution=(1280,720),
  supersampling=false (ConfigFile.hs:66-81).
* ``Camera``: position, lookAt, upVec, fov — all required (ConfigFile.hs:34-38).

The config splits into

* ``SceneParams`` — dataclasses of tensors (camera pose/fov, disk
  radii/opacity/colour, star intensity/saturation, bloom strength, and the
  black-hole mass ``rs``, which the reference hard-codes to 1), and
* ``StaticConfig`` — hashable facts that fix shapes and loop bounds
  (resolution, supersampling, step size, step cap, bloom divider, dtype).

Derived-config rules mirror ``Raytracer.hs:58-63`` (safe distance
``max(50², 2·|camPos|²)``, 2× resolution under supersampling) and
``app/Main.hs:93-103`` (preview shrink to a 300-px long side with
supersampling and bloom disabled).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import yaml

Vec3 = Tuple[float, float, float]

# Defaults per reference ConfigFile.hs:66-81.
_SCENE_DEFAULTS = dict(
    stepSize=0.3,
    bloomStrength=0.4,
    bloomDivider=25,
    starIntensity=0.7,
    starSaturation=0.7,
    diskColor=(0.16, 0.1, 0.95),  # HSI with hue already normalised to [0,1)
    diskOpacity=0.0,
    diskInner=3.0,
    diskOuter=12.0,
    resolution=(1280, 720),
    supersampling=False,
)

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a scene's ``dtype`` string."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported scene dtype {name!r}; "
                         f"expected one of {sorted(_TORCH_DTYPES)}") from None


@dataclass
class Camera:
    """Pinhole camera (reference ConfigFile.hs:34-38)."""

    position: Vec3
    look_at: Vec3
    up: Vec3
    fov: float  # tangent of the horizontal view half-angle, ×2

    @classmethod
    def from_dict(cls, d: dict) -> "Camera":
        try:
            return cls(
                position=tuple(float(v) for v in d["position"]),
                look_at=tuple(float(v) for v in d["lookAt"]),
                up=tuple(float(v) for v in d["upVec"]),
                fov=float(d["fov"]),
            )
        except KeyError as e:
            raise ValueError(f"camera config missing required key: {e}") from e

    def to_dict(self) -> dict:
        return {
            "position": list(self.position),
            "lookAt": list(self.look_at),
            "upVec": list(self.up),
            "fov": self.fov,
        }


@dataclass
class Scene:
    """Scene settings (reference ConfigFile.hs:20-32, defaults :66-81)."""

    step_size: float = _SCENE_DEFAULTS["stepSize"]
    bloom_strength: float = _SCENE_DEFAULTS["bloomStrength"]
    bloom_divider: int = _SCENE_DEFAULTS["bloomDivider"]
    star_intensity: float = _SCENE_DEFAULTS["starIntensity"]
    star_saturation: float = _SCENE_DEFAULTS["starSaturation"]
    disk_color: Vec3 = _SCENE_DEFAULTS["diskColor"]  # HSI, hue in [0,1)
    disk_opacity: float = _SCENE_DEFAULTS["diskOpacity"]
    disk_inner: float = _SCENE_DEFAULTS["diskInner"]
    disk_outer: float = _SCENE_DEFAULTS["diskOuter"]
    resolution: Tuple[int, int] = _SCENE_DEFAULTS["resolution"]  # (width, height)
    supersampling: bool = _SCENE_DEFAULTS["supersampling"]

    # --- extensions (not in the reference schema) ---
    mass: float = 1.0  # Schwarzschild radius rs; reference hard-codes rs=1
    max_steps: Optional[int] = None  # integration step cap; None -> auto
    dtype: str = "float32"  # compute dtype: float32 or float64 (golden runs)

    @classmethod
    def from_dict(cls, d: dict) -> "Scene":
        d = dict(d or {})
        disk_color = d.pop("diskColor", None)
        if disk_color is not None:
            # YAML stores hue in degrees; normalise /360 (ConfigFile.hs:50-51).
            h, s, i = (float(v) for v in disk_color)
            disk_color = (h / 360.0, s, i)
        else:
            disk_color = _SCENE_DEFAULTS["diskColor"]
        res = d.pop("resolution", _SCENE_DEFAULTS["resolution"])
        max_steps = d.pop("maxSteps", None)
        return cls(
            step_size=float(d.pop("stepSize", _SCENE_DEFAULTS["stepSize"])),
            bloom_strength=float(d.pop("bloomStrength", _SCENE_DEFAULTS["bloomStrength"])),
            bloom_divider=int(d.pop("bloomDivider", _SCENE_DEFAULTS["bloomDivider"])),
            star_intensity=float(d.pop("starIntensity", _SCENE_DEFAULTS["starIntensity"])),
            star_saturation=float(d.pop("starSaturation", _SCENE_DEFAULTS["starSaturation"])),
            disk_color=disk_color,
            disk_opacity=float(d.pop("diskOpacity", _SCENE_DEFAULTS["diskOpacity"])),
            disk_inner=float(d.pop("diskInner", _SCENE_DEFAULTS["diskInner"])),
            disk_outer=float(d.pop("diskOuter", _SCENE_DEFAULTS["diskOuter"])),
            resolution=(int(res[0]), int(res[1])),
            supersampling=bool(d.pop("supersampling", _SCENE_DEFAULTS["supersampling"])),
            mass=float(d.pop("mass", 1.0)),
            max_steps=(int(max_steps) if max_steps is not None else None),
            dtype=str(d.pop("dtype", "float32")),
        )
        # Unknown keys (e.g. the reference animation example's `diskHSV`)
        # are ignored, matching aeson `.:?`.

    def to_dict(self) -> dict:
        h, s, i = self.disk_color
        d = {
            "stepSize": self.step_size,
            "bloomStrength": self.bloom_strength,
            "bloomDivider": self.bloom_divider,
            "starIntensity": self.star_intensity,
            "starSaturation": self.star_saturation,
            "diskColor": [h * 360.0, s, i],
            "diskOpacity": self.disk_opacity,
            "diskInner": self.disk_inner,
            "diskOuter": self.disk_outer,
            "resolution": list(self.resolution),
            "supersampling": self.supersampling,
        }
        # Extension fields are emitted only when non-default, so untouched
        # configs stay byte-compatible with the reference schema.
        if self.mass != 1.0:
            d["mass"] = self.mass
        if self.max_steps is not None:
            d["maxSteps"] = self.max_steps
        if self.dtype != "float32":
            d["dtype"] = self.dtype
        return d


@dataclass
class Config:
    """Top-level config = scene + camera (reference ConfigFile.hs:16-18)."""

    scene: Scene
    camera: Camera

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        if "camera" not in d:
            raise ValueError("config missing required 'camera' section")
        return cls(
            scene=Scene.from_dict(d.get("scene", {})),
            camera=Camera.from_dict(d["camera"]),
        )

    def to_dict(self) -> dict:
        return {"scene": self.scene.to_dict(), "camera": self.camera.to_dict()}

    def params(self, device, dtype: Optional[torch.dtype] = None) -> "SceneParams":
        return scene_params(self, device, dtype)

    def static(self, preview: bool = False) -> "StaticConfig":
        return static_config(self, preview=preview)


def load_config(path: str) -> Config:
    with open(path) as f:
        d = yaml.safe_load(f)
    if not isinstance(d, dict):
        raise ValueError(f"{path}: expected a YAML mapping at top level")
    return Config.from_dict(d)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)


# ---------------------------------------------------------------------------
# Scene parameters as tensors
# ---------------------------------------------------------------------------


@dataclass
class CameraParams:
    position: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    fov: torch.Tensor  # ()


@dataclass
class DiskParams:
    inner: torch.Tensor  # () radius (not squared)
    outer: torch.Tensor  # ()
    opacity: torch.Tensor  # ()
    color_hsi: torch.Tensor  # (3,) hue in [0,1)


@dataclass
class StarParams:
    intensity: torch.Tensor  # ()
    saturation: torch.Tensor  # ()


@dataclass
class SceneParams:
    """All scene parameters that enter the math, as tensors on one device."""

    camera: CameraParams
    disk: DiskParams
    stars: StarParams
    bloom_strength: torch.Tensor  # ()
    mass: torch.Tensor  # () Schwarzschild radius rs


# The parameter leaves in the JAX package's pytree flatten order (dataclass
# field order, depth first), which its checkpoints and masks follow.
LEAF_PATHS = (
    "camera.position", "camera.look_at", "camera.up", "camera.fov",
    "disk.inner", "disk.outer", "disk.opacity", "disk.color_hsi",
    "stars.intensity", "stars.saturation",
    "bloom_strength", "mass",
)


def _get(tree, path: str):
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


def param_leaves(params: SceneParams):
    """``[(dotted path, tensor), ...]`` in the JAX package's flatten order,
    paths as its ``trainable_mask`` spells them (``".camera.position"``,
    ``".disk.outer"``, ...)."""
    return [("." + p, _get(params, p)) for p in LEAF_PATHS]


def params_from_leaves(leaves) -> SceneParams:
    """The inverse of :func:`param_leaves`: SceneParams from tensors in
    :data:`LEAF_PATHS` order (kept as they are: same objects, devices and
    dtypes)."""
    leaves = list(leaves)
    if len(leaves) != len(LEAF_PATHS):
        raise ValueError(f"expected {len(LEAF_PATHS)} parameter leaves, got {len(leaves)}")
    v = dict(zip(LEAF_PATHS, leaves))
    return SceneParams(
        camera=CameraParams(position=v["camera.position"], look_at=v["camera.look_at"],
                            up=v["camera.up"], fov=v["camera.fov"]),
        disk=DiskParams(inner=v["disk.inner"], outer=v["disk.outer"],
                        opacity=v["disk.opacity"], color_hsi=v["disk.color_hsi"]),
        stars=StarParams(intensity=v["stars.intensity"], saturation=v["stars.saturation"]),
        bloom_strength=v["bloom_strength"],
        mass=v["mass"],
    )


def _params(get, device, dtype: torch.dtype) -> SceneParams:
    """Assemble SceneParams from ``get(path)`` values (path like
    ``"camera.position"``)."""
    return params_from_leaves(
        torch.tensor(np.asarray(get(path), np.float64), dtype=dtype, device=device)
        for path in LEAF_PATHS)


def scene_params(cfg: Config, device, dtype: Optional[torch.dtype] = None) -> SceneParams:
    """The scene's parameters as tensors of ``dtype`` (default: the scene's
    own dtype) on ``device``."""
    dt = dtype or torch_dtype(cfg.scene.dtype)
    values = {
        "camera.position": cfg.camera.position,
        "camera.look_at": cfg.camera.look_at,
        "camera.up": cfg.camera.up,
        "camera.fov": cfg.camera.fov,
        "disk.inner": cfg.scene.disk_inner,
        "disk.outer": cfg.scene.disk_outer,
        "disk.opacity": cfg.scene.disk_opacity,
        "disk.color_hsi": cfg.scene.disk_color,
        "stars.intensity": cfg.scene.star_intensity,
        "stars.saturation": cfg.scene.star_saturation,
        "bloom_strength": cfg.scene.bloom_strength,
        "mass": cfg.scene.mass,
    }
    return _params(values.__getitem__, device, dt)


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None) -> SceneParams:
    """SceneParams from any object with the same attribute nesting whose
    leaves are numpy arrays (``camera.position``, ``disk.inner``, ...), such
    as the JAX package's ``SceneParams`` mapped through ``np.asarray``.
    ``dtype`` defaults to the leaves' own float dtype."""
    get = lambda path: _get(tree, path)
    if dtype is None:
        dtype = torch_dtype(str(np.asarray(get("mass")).dtype))
    return _params(get, device, dtype)


def config_with_params(cfg: Config, params: SceneParams) -> Config:
    """Write a (possibly fitted) SceneParams back into a Config — the
    inverse of :func:`scene_params`. Static fields (resolution, flags, step
    cap, dtype) are kept from ``cfg``."""
    f = lambda v: float(v.detach())
    t3 = lambda v: tuple(float(x) for x in v.detach().cpu().tolist())
    camera = Camera(
        position=t3(params.camera.position),
        look_at=t3(params.camera.look_at),
        up=t3(params.camera.up),
        fov=f(params.camera.fov),
    )
    scene = dataclasses.replace(
        cfg.scene,
        disk_inner=f(params.disk.inner),
        disk_outer=f(params.disk.outer),
        disk_opacity=f(params.disk.opacity),
        disk_color=t3(params.disk.color_hsi),
        star_intensity=f(params.stars.intensity),
        star_saturation=f(params.stars.saturation),
        bloom_strength=f(params.bloom_strength),
        mass=f(params.mass),
    )
    return Config(scene=scene, camera=camera)


# ---------------------------------------------------------------------------
# Static (hashable) config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StaticConfig:
    """Shapes, loop bounds and switches of one render. Hashable."""

    width: int  # output width
    height: int  # output height
    render_width: int  # internal render width (2× under supersampling)
    render_height: int
    supersampling: bool
    step_size: float
    max_steps: int
    bloom_divider: int
    disk_on: bool  # diskOpacity != 0 at config time (Raytracer/findColor gate)
    dtype: str = "float32"

    @property
    def n_rays(self) -> int:
        return self.render_width * self.render_height

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def preview_resolution(width: int, height: int, long_side: int = 300) -> Tuple[int, int]:
    """Preview shrink: cap the long side, preserve aspect (app/Main.hs:96-99)."""
    if width >= height:
        return long_side, long_side * height // width
    return long_side * width // height, long_side


def default_max_steps(cfg: Config) -> int:
    """Static cap on integration steps.

    The reference loops until every ray hits the horizon or escapes past
    ``safeDistance = max(50², 2·|camPos|²)`` with no cap (Raytracer.hs:77-86).
    The cap bounds the travelled path by camera distance + twice the escape
    radius + a margin for photon-sphere orbits (worst case near r = 1.5·rs);
    the tests check that no ray is truncated on the reference scenes.
    """
    cam = np.asarray(cfg.camera.position, dtype=np.float64)
    r2cam = float(np.dot(cam, cam))
    # Escape radius and the photon-orbit margin both scale with rs.
    mass = float(cfg.scene.mass)
    safe = max((50.0 * mass) ** 2, 2.0 * r2cam)
    r_safe = math.sqrt(safe)
    path = math.sqrt(r2cam) + 2.0 * r_safe + 60.0 * max(1.0, mass)
    return int(math.ceil(path / cfg.scene.step_size))


def static_config(cfg: Config, preview: bool = False) -> StaticConfig:
    w, h = cfg.scene.resolution
    ss = cfg.scene.supersampling
    if preview:
        w, h = preview_resolution(w, h)
        ss = False
    rw, rh = (2 * w, 2 * h) if ss else (w, h)
    return StaticConfig(
        width=w,
        height=h,
        render_width=rw,
        render_height=rh,
        supersampling=ss,
        step_size=float(cfg.scene.step_size),
        max_steps=(
            cfg.scene.max_steps
            if cfg.scene.max_steps is not None
            else default_max_steps(cfg)
        ),
        bloom_divider=int(cfg.scene.bloom_divider),
        disk_on=(cfg.scene.disk_opacity != 0.0),
        dtype=str(cfg.scene.dtype),
    )


def apply_preview(cfg: Config) -> Config:
    """Return a preview variant of a config (app/Main.hs:93-103)."""
    w, h = cfg.scene.resolution
    scn = dataclasses.replace(
        cfg.scene,
        resolution=preview_resolution(w, h),
        supersampling=False,
        bloom_strength=0.0,
    )
    return Config(scene=scn, camera=cfg.camera)
