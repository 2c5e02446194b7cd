"""Image output: gamma postprocess and PNG writing (reference:
RayTracingWeekend.cpp:244, 252-286). Pure numpy + zlib; the native
codec library of the JAX package is not needed here."""
from __future__ import annotations

import struct as _struct
import zlib

import numpy as np

__all__ = ["postprocess", "write_png"]


def postprocess(canvas: np.ndarray) -> np.ndarray:
    """Gamma-2 (sqrt) + clamp to [0, 1] (RayTracingWeekend.cpp:244)."""
    return np.minimum(np.sqrt(np.maximum(np.asarray(canvas, np.float64), 0.0)),
                      1.0)


def _quantize(canvas01: np.ndarray) -> np.ndarray:
    """int(255.99 * c) quantization (RayTracingWeekend.cpp:268-270)."""
    return (255.99 * np.asarray(canvas01, np.float64)).astype(np.int32).clip(
        0, 255).astype(np.uint8)


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
