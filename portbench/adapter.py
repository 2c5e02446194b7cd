"""The system under test, as the harness drives it: the renderer's
`render()` entry with `loop_mode="auto"`, its `RenderStats` counters, and
the launch-plan knobs its megakernel launches take. The only module of
the benchmark that imports the program."""
from __future__ import annotations

from raytracingweekend_tpu_torch import render as _render
from raytracingweekend_tpu_torch.ops import megakernel as _mk
from raytracingweekend_tpu_torch.utils.config import RenderConfig


class Counters(_render.RenderStats):
    """The program's per-render counters (`segments`, `trace_seconds`)
    without the per-launch float64 variance that `RenderStats` also
    keeps, which would add device work to the traced window."""

    def update_variance(self, launch_mean) -> None:
        pass


def render_config(nx: int, ny: int, spp: int, max_depth: int,
                  samples_per_launch: int, seed: int,
                  device: str = "cuda") -> RenderConfig:
    """The render() configuration of one image: the config's sizes, the
    mix's launch size, and the program's defaults for everything else
    (tile width included)."""
    return RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                        seed=seed, samples_per_launch=samples_per_launch,
                        loop_mode="auto", device=device)


def render(scene, cfg: RenderConfig, stats=None):
    """One image through the program's entry point."""
    return _render.render(scene, cfg, stats=stats)


def plan_knobs(scene, cfg: RenderConfig) -> dict:
    """The launch-plan choices of the program's megakernel launch for
    `cfg`, as `render()` asks `make_plan` for them: the tile width, the
    layout modes and the culling, as `make_plan` keywords. They set how
    the random numbers are keyed (tile, lane), so the reference builds its
    own plan with them. Raises ValueError where `render()` would not take
    the megakernel."""
    mode = _render.resolve_mode(scene, cfg.loop_mode)
    if mode != "mega":
        raise ValueError(f"render() takes the {mode!r} loop on this scene; "
                         "the benchmark's reference follows the megakernel")
    chunk = min(cfg.samples_per_launch, cfg.spp)
    _, plan = _mk.make_plan(scene, cfg.nx, cfg.ny, chunk,
                            max_depth=cfg.max_depth, T=cfg.tile_lanes)
    return dict(T=plan.T, SB=plan.SB, cull=plan.cull,
                dyn_order=plan.dyn_order, slots_per_pixel=plan.k,
                coherent=plan.coherent, super_group=plan.sg,
                batch_votes=plan.batch_votes, unroll=plan.unroll,
                rr_depth=plan.rr_depth)
