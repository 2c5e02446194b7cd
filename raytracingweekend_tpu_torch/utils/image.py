"""Image I/O: gamma postprocess, PPM and PNG writing (reference:
RayTracingWeekend.cpp:244, 252-286), and texture loading from the raw RTWI
format. Pure numpy + zlib; the native codec library of the JAX package is
not needed here."""
from __future__ import annotations

import struct as _struct
import zlib

import numpy as np

__all__ = ["postprocess", "write_ppm", "write_png", "load_image"]


def postprocess(canvas: np.ndarray) -> np.ndarray:
    """Gamma-2 (sqrt) + clamp to [0, 1] (RayTracingWeekend.cpp:244)."""
    return np.minimum(np.sqrt(np.maximum(np.asarray(canvas, np.float64), 0.0)),
                      1.0)


def _quantize(canvas01: np.ndarray) -> np.ndarray:
    """int(255.99 * c) quantization (RayTracingWeekend.cpp:268-270)."""
    return (255.99 * np.asarray(canvas01, np.float64)).astype(np.int32).clip(
        0, 255).astype(np.uint8)


def write_ppm(canvas01: np.ndarray, path: str) -> None:
    """P3 PPM, rows written top of image first (cpp:261-275): `canvas01` is
    (ny, nx, 3) in [0, 1] with row 0 at the image bottom. Byte for byte
    the JAX package's `write_ppm`."""
    ny, nx, _ = canvas01.shape
    q = _quantize(canvas01)
    lines = [f"P3\n{nx} {ny}\n255\n"]
    for j in range(ny - 1, -1, -1):
        lines.append("\n".join(f"{r} {g} {b}" for r, g, b in q[j]) + "\n")
    with open(path, "w") as f:
        f.write("".join(lines))


def write_png(canvas01: np.ndarray, path: str) -> None:
    """8-bit RGB PNG. `canvas01` is (ny, nx, 3) in [0, 1] with row 0 at the
    image bottom (the reference canvas layout); PNG rows are top-down."""
    ny, nx, _ = canvas01.shape
    q = _quantize(canvas01)[::-1]
    raw = b"".join(b"\x00" + q[j].tobytes() for j in range(ny))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (_struct.pack(">I", len(payload)) + tag + payload
                + _struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = _struct.pack(">IIBBBBB", nx, ny, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def load_image(path: str) -> np.ndarray:
    """Load a texture as float (ny, nx, 3) in [0, 1], row 0 at the image
    bottom: the convention `SceneBuilder.image` takes.

    Reads the raw RTWI format that tools/export_texture_raw.py writes and
    the reference oracle reads: b"RTWI <nx> <ny>\n", then nx * ny * 3 RGB8
    bytes, row-major, row 0 at the top. Other formats (PNG, JPEG, PPM)
    raise ValueError."""
    if not path.lower().endswith(".rtwi"):
        raise ValueError(f"unsupported image format for {path!r} (the "
                         "port reads .rtwi textures)")
    with open(path, "rb") as f:
        header = f.readline().split()
        if len(header) != 3 or header[0] != b"RTWI":
            raise ValueError(f"bad RTWI header in {path!r}")
        nx, ny = int(header[1]), int(header[2])
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != nx * ny * 3:
        raise ValueError(f"{path!r}: {data.size} texel bytes for {nx}x{ny}")
    return data.reshape(ny, nx, 3)[::-1] / 255.0
