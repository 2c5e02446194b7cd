"""Scene data carried across from the JAX package.

`scene_from_arrays` is the port's counterpart of loading weights: it takes
the leaves of a JAX `Scene` as numpy arrays, keyed by their dotted field
path ("spheres.center0", "camera.lens_radius", ...), plus the scene's
static fields, and returns the port's `Scene` holding exactly those arrays.
This module imports no JAX: the caller flattens the JAX scene, e.g.

    leaves = jax.tree_util.tree_flatten_with_path(jax_scene)[0]
    arrays = {".".join(k.name for k in path): np.asarray(leaf)
              for path, leaf in leaves}
    static = {f: getattr(jax_scene, f) for f in STATIC_FIELDS}
    static["lights.num"] = jax_scene.lights.num
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import scene_types as st

_TABLES = {
    "spheres": st.Spheres, "rects": st.Rects, "media": st.Media,
    "materials": st.Materials, "textures": st.Textures,
    "lights": st.Lights, "camera": st.Camera,
}


def scene_from_arrays(arrays: dict[str, np.ndarray], static: dict) -> st.Scene:
    """Build the port's Scene from a JAX Scene's leaves and static fields.

    The `bvh.*` leaves of a scene built with `use_bvh=True` become its
    ops/bvh.SphereBVH. Raises ValueError on a key the port's Scene has no
    field for, or a table field that is missing."""
    by_table: dict[str, dict] = {name: {} for name in _TABLES}
    by_table["bvh"] = {}
    for key, value in arrays.items():
        table, _, field = key.partition(".")
        if table not in by_table or not field:
            raise ValueError(f"unknown scene leaf {key!r}")
        by_table[table][field] = np.asarray(value)
    by_table["lights"]["num"] = int(static.get("lights.num", 0))

    parts = {}
    tables = dict(_TABLES)
    if by_table["bvh"]:
        from ..ops.bvh import SphereBVH
        tables["bvh"] = SphereBVH
    for table, cls in tables.items():
        names = {f.name for f in dataclasses.fields(cls)}
        got = by_table[table]
        unknown = set(got) - names
        if unknown:
            raise ValueError(f"unknown {table} fields {sorted(unknown)}")
        required = {f.name for f in dataclasses.fields(cls)
                    if f.default is dataclasses.MISSING}
        missing = required - set(got)
        if missing:
            raise ValueError(f"missing {table} fields {sorted(missing)}")
        parts[table] = cls(**got)

    flags = {name: static[name] for name in st.STATIC_FIELDS
             if name in static}
    if "noise_modes" in flags:
        flags["noise_modes"] = tuple(flags["noise_modes"])
    return st.Scene(**parts, **flags)
