"""Flat SoA scene representation as plain dataclasses of numpy arrays.

The port's counterpart of raytracingweekend_tpu/models/scene_types.py: the
same tables, field names, dtypes and type codes, without flax. A scene is
host data; the megakernel's host plan (ops/megakernel.py) packs it into
device tensors per launch geometry.

Every hittable of the reference normalizes to a row in one of three padded
tables (spheres, axis rects, constant media); materials and textures are
type-coded rows in their own tables; image textures keep their texels in
`Textures.images`. A scene round-trips field for field with the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

# Material type codes (material.h class hierarchy).
MAT_LAMBERTIAN = 0   # material.h:77-122
MAT_METAL = 1        # material.h:124-140
MAT_DIELECTRIC = 2   # material.h:142-225
MAT_DIFFUSE_LIGHT = 3  # material.h:227-247
MAT_ISOTROPIC = 4    # material.h:252-265

# Texture type codes (texture.h class hierarchy).
TEX_CONSTANT = 0  # texture.h:16-27
TEX_CHECKER = 1   # texture.h:29-50
TEX_NOISE = 2     # texture.h:52-71
TEX_IMAGE = 3     # texture.h:73-98

# noise_texture display modes (texture.h:59-67).
NOISE_MARBLE = 0
NOISE_SMOOTH = 1
NOISE_TURB = 2

# Axis-rect orientation codes (hittable.h:142-267).
RECT_XY = 0
RECT_XZ = 1
RECT_YZ = 2

# Constant-medium boundary kinds.
MEDIUM_SPHERE = 0
MEDIUM_BOX = 1

# Light table kinds.
LIGHT_RECT = 0
LIGHT_SPHERE = 1

# Scene-level enums (Scene/scene.h:6-16).
RENDER_SHADED = 0
RENDER_NORMAL = 1
BG_BLACK = 0
BG_GRADIENT = 1


@dataclasses.dataclass
class Spheres:
    """sphere / moving_sphere rows (sphere.h:40-131). Static spheres store
    center1 == center0; a negative radius flips the normal inward (the
    hollow glass ball, Scene/scene.h:85-86)."""
    center0: np.ndarray   # (S, 3) float32
    center1: np.ndarray   # (S, 3) float32
    time0: np.ndarray     # (S,) float32
    time1: np.ndarray     # (S,) float32
    radius: np.ndarray    # (S,) float32
    mat: np.ndarray       # (S,) int32
    active: np.ndarray    # (S,) bool


@dataclasses.dataclass
class Rects:
    """Axis-aligned rect rows with baked instancing transform."""
    axis: np.ndarray      # (R,) int32
    a0: np.ndarray        # (R,) float32
    a1: np.ndarray
    b0: np.ndarray
    b1: np.ndarray
    k: np.ndarray
    flip: np.ndarray
    cos_t: np.ndarray
    sin_t: np.ndarray
    offset: np.ndarray    # (R, 3) float32
    mat: np.ndarray       # (R,) int32
    active: np.ndarray    # (R,) bool


@dataclasses.dataclass
class Media:
    """constant_medium rows (hittable.h:420-489)."""
    kind: np.ndarray      # (V,) int32
    p0: np.ndarray        # (V, 3) float32
    p1: np.ndarray        # (V, 3) float32
    cos_t: np.ndarray     # (V,) float32
    sin_t: np.ndarray
    offset: np.ndarray    # (V, 3) float32
    density: np.ndarray   # (V,) float32
    mat: np.ndarray       # (V,) int32
    active: np.ndarray    # (V,) bool


@dataclasses.dataclass
class Materials:
    """Type-coded material rows; colors go through the texture table."""
    mtype: np.ndarray     # (M,) int32
    tex: np.ndarray       # (M,) int32
    fuzz: np.ndarray      # (M,) float32
    ref_idx: np.ndarray   # (M,) float32


@dataclasses.dataclass
class Textures:
    """Type-coded texture rows."""
    ttype: np.ndarray        # (T,) int32
    color: np.ndarray        # (T, 3) float32
    scale: np.ndarray        # (T,) float32
    noise_mode: np.ndarray   # (T,) int32
    even: np.ndarray         # (T,) int32
    odd: np.ndarray          # (T,) int32
    image_id: np.ndarray     # (T,) int32
    images: Optional[np.ndarray] = None     # (I, H, W, 3) float32
    image_hw: Optional[np.ndarray] = None   # (I, 2) int32


@dataclasses.dataclass
class Lights:
    """The MIS lights list (Scene/scene.h:27,35): rows into the rect and
    sphere tables; `num` is the true count (the arrays hold >= 1 row)."""
    kind: np.ndarray     # (L,) int32
    index: np.ndarray    # (L,) int32
    num: int = 0


@dataclasses.dataclass
class Camera:
    """Thin-lens look-at camera (camera.h:7-74), precomputed basis."""
    origin: np.ndarray             # (3,) float32
    lower_left_corner: np.ndarray  # (3,)
    horizontal: np.ndarray         # (3,)
    vertical: np.ndarray           # (3,)
    u: np.ndarray                  # (3,)
    v: np.ndarray                  # (3,)
    w: np.ndarray                  # (3,)
    lens_radius: np.ndarray        # () float32
    time0: np.ndarray              # ()
    time1: np.ndarray              # ()


@dataclasses.dataclass
class Scene:
    """The flat scene: tables + camera + the static capability flags the
    JAX package keys its compiled paths on."""
    spheres: Spheres
    rects: Rects
    media: Media
    materials: Materials
    textures: Textures
    lights: Lights
    camera: Camera
    bvh: Optional[Any] = None
    background: int = BG_GRADIENT
    render_type: int = RENDER_SHADED
    has_moving_spheres: bool = False
    has_rect_transforms: bool = False
    has_media: bool = False
    has_noise_tex: bool = False
    noise_modes: tuple = ()
    has_image_tex: bool = False
    has_checker_tex: bool = False
    has_metal: bool = True
    has_dielectric: bool = True
    has_isotropic: bool = True
    has_lights_mat: bool = True
    lambertian_strategy: str = "mis"
    needs_legacy_textures: bool = False
    name: str = ""


# Fields of Scene that are plain values, not tables (the JAX package's
# pytree_node=False fields).
STATIC_FIELDS = ("background", "render_type", "has_moving_spheres",
                 "has_rect_transforms", "has_media", "has_noise_tex",
                 "noise_modes", "has_image_tex", "has_checker_tex",
                 "has_metal", "has_dielectric", "has_isotropic",
                 "has_lights_mat", "lambertian_strategy",
                 "needs_legacy_textures", "name")
