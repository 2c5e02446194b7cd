"""Render configuration — the runtime replacement for the reference's
compile-time constants (reference: RayTracingWeekend.cpp:32-43, 199-202).
Mirrors raytracingweekend_tpu/utils/config.py with a `device` field."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RenderConfig:
    nx: int = 400                 # cpp:35 (100 * size_multiplier)
    ny: int = 400                 # cpp:36
    spp: int = 64                 # subPixelCount, cpp:33
    max_depth: int = 100          # cpp:42
    seed: int = 0
    # Samples per pixel traced by one kernel launch.
    samples_per_launch: int = 8
    # "regen" (the path-regenerative wavefront, the JAX package's default),
    # "tiled", "while", "scan", "mega" (the fused megakernel) or "auto"
    # (mega where the megakernel covers the scene, else regen).
    loop_mode: str = "regen"
    # Megakernel tile width: lanes per CUDA block in overdraw mode (at most
    # 1024, the block limit).
    tile_lanes: int = 256
    # Torch device the render runs on ("cuda" launches the CUDA kernel,
    # "cpu" runs its plain PyTorch version).
    device: str = "cuda"

    @property
    def aspect(self) -> float:
        return self.nx / self.ny
