"""Write the earth texels as the reference oracle's raw RTWI file.

The port of tools/export_texture_raw.py. The reference's image_texture
(texture.h:73-98) reads a flat array of RGB8 texels with row 0 at the
image top, and the reference oracle (tools/reference_oracle) reads them
from this format: b"RTWI <nx> <ny>\\n", then nx * ny * 3 bytes, row-major,
row 0 at the top. The texels are those the earth scenes render:
`models.scenes.earth_texture_path(--image)` (the given image, else the
repo's assets/earth.jpg), read by `utils.image.load_image` (PNG, PPM,
JPEG or RTWI; JPEG through the native library). Where no candidate
decodes, the tool refuses (exit status 1) rather than write the
procedural stand-in that the earth scenes fall back to: an oracle
texture that disagrees with the renders would make every earth golden
wrong.

    python -m raytracingweekend_tpu_torch.tools.export_texture_raw
        OUT.rtwi [--image PATH]

Unlike the JAX tool it names its output explicitly: the repo's
tools/reference_oracle/earth.rtwi is the oracle's own file.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models.scenes import earth_texture_path
from ..utils.image import load_image


def export(out: str, image_path: str | None = None) -> tuple:
    """Write the texels of `earth_texture_path(image_path)` to `out` as
    RTWI; returns (nx, ny). Raises SystemExit where no candidate
    decodes."""
    cand = earth_texture_path(image_path)
    if cand is None:
        raise SystemExit(
            "export_texture_raw: no decodable earth texture (--image, or "
            "assets/earth.jpg with the native JPEG decoder): refusing to "
            "export the procedural stand-in as the oracle texture")
    pix = np.asarray(load_image(cand), np.float64)   # row 0 at the bottom
    ny, nx, _ = pix.shape
    data = np.rint(pix * 255.0).astype(np.uint8)[::-1]   # row 0 at the top
    with open(out, "wb") as f:
        f.write(f"RTWI {nx} {ny}\n".encode())
        f.write(data.tobytes())
    return nx, ny


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="the RTWI file to write")
    ap.add_argument("--image", default=None,
                    help="the texels' image (default: assets/earth.jpg)")
    args = ap.parse_args(argv)
    nx, ny = export(args.out, args.image)
    print(f"wrote {args.out}: {nx}x{ny}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
