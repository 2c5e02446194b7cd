"""The benchmark of the renderer's PyTorch and CUDA port: one run of one
cell.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`
(`workloads`), its configuration file (`configs`' `file`: scene, image
size, samples and depth, and how the output check samples the run), the
configuration's own scene generator where it brings one (`scene_file`,
under `reference/`), its traffic mix `traffic/<mix>.json`, and one reader
a per-layer metric, `metrics/<metric>.py`. A run

1. builds the scene from the configuration with the reference's
   generator (`make_scene`), hands it to the program, and warms up every
   shape the mix uses (set-up);
2. renders whole images back to back through `render()` until
   `--seconds` have passed, one closed-loop client, each image ending in
   a device synchronisation (the window, from the first image's start to
   the last image's end);
3. recomputes a sample of the window's images, drawn from the seed, on a
   sample of their tiles with the plain reference, and compares;
4. prints the result as one JSON line, last on standard output, with the
   numbers compared beside their limits last on standard error.

With `--trace 0` it reports the cell's end-to-end metrics; with
`--trace 1` a `torch.profiler` trace of the whole window (and the
program's `RenderStats` counters) feeds the per-layer metrics.
"""
from __future__ import annotations

import argparse
import ast
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# module names (top level, compared whole) that no run may hold once the
# window has closed: the JAX package the port was made from, and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingweekend_tpu")
# stream tags of the seed: image seeds, warm-up image seeds, the sample of
# checked images, the sample of their tiles
TAG_IMAGE, TAG_WARM, TAG_CHECK, TAG_TILES = 1, 2, 3, 4


class BenchError(Exception):
    """A run that cannot produce a result: exit non-zero, print none."""


# ---------------------------------------------------------------------------
# Finding a cell by name
# ---------------------------------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find_cell(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The cell `name` of `spec` with its configuration, traffic mix and
    metrics: {"workload", "config", "traffic", "pkg" (the benchmark's
    folder), "end_to_end", "per_layer"}."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                         f"(has {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    pkg = root / PKG.name
    traffic = json.loads(
        (pkg / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {"workload": cell, "config": config, "traffic": traffic,
            "pkg": pkg,
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)]}


def metric_reader(name: str, pkg: Path = PKG):
    """The `read(ctx)` function of metric `name`: `metrics/<name>.py`, or
    where there is none, the reader of its quantity, `metrics/<stem>.py`
    for the name up to its first dot (one quantity split by the
    end-to-end metric it moves: `segments_per_s.rate`,
    `segments_per_s.p95`)."""
    path = pkg / "metrics" / f"{name}.py"
    if not path.exists():
        path = pkg / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# what a configuration's own scene file may import: the frozen reference's
# scene-building modules (relative, or under `<benchmark>.reference`), and
# these libraries; never the program or JAX
SCENE_MODULES = frozenset({"builder", "scene_types", "detrng"})
SCENE_LIBRARIES = frozenset({"__future__", "math", "pathlib", "numpy"})


def scene_imports_refused(path: Path) -> list:
    """The imports of scene file `path` that it may not make (see
    SCENE_MODULES), as written in the file; [] where it makes none."""
    ref = f"{PKG.name}.reference"

    def allowed(module: str, names=()) -> bool:
        if module.split(".")[0] in SCENE_LIBRARIES:
            return True
        if module == ref:
            return bool(names) and set(names) <= SCENE_MODULES
        head, _, tail = module.rpartition(".")
        return head == ref and tail in SCENE_MODULES

    refused = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            refused += [a.name for a in node.names if not allowed(a.name)]
        elif isinstance(node, ast.ImportFrom):
            names = [a.name for a in node.names]
            if node.level == 0:
                ok = allowed(node.module, names)
            elif node.level == 1:
                ok = (node.module in SCENE_MODULES if node.module
                      else set(names) <= SCENE_MODULES)
            else:
                ok = False
            if not ok:
                refused.append("." * node.level + (node.module or "")
                               + f" ({', '.join(names)})")
    return refused


def make_scene(cell: dict, aspect: float):
    """The scene of `cell`'s configuration at image aspect `aspect`. A
    configuration with a `scene_file` (a path from the checkout's root,
    under the benchmark's `reference/`) brings its own generator: that
    file's `make_scene(aspect, **scene_args)`. Without one, `scene` names
    a generator of the reference's `scenes.py`, given `scene_args` too."""
    conf = cell["config"]
    args = conf.get("scene_args", {})
    if "scene_file" not in conf:
        from .reference import scenes as rscenes
        return rscenes.make_scene(conf["scene"], aspect, **args)
    ref = (cell["pkg"] / "reference").resolve()
    path = (cell["pkg"].parent / conf["scene_file"]).resolve()
    if ref not in path.parents or path.suffix != ".py" or \
            not path.is_file():
        raise BenchError(f"scene_file {conf['scene_file']!r} is no Python "
                         f"file under {PKG.name}/reference/")
    refused = scene_imports_refused(path)
    if refused:
        raise BenchError(f"scene_file {conf['scene_file']!r} imports what "
                         f"a scene of the reference may not: {refused}")
    spec = importlib.util.spec_from_file_location(
        f"{PKG.name}.reference.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_scene(aspect, **args)


# ---------------------------------------------------------------------------
# Seeds and statistics
# ---------------------------------------------------------------------------

def _entropy(seed: int) -> int:
    return int(seed) % (1 << 64)


def image_seed(seed: int, tag: int, index: int) -> int:
    """The render seed (non-negative int32) of image `index` of stream
    `tag` of a run seeded `seed`: every seed gets the same work, in other
    random numbers."""
    ss = np.random.SeedSequence([_entropy(seed), tag, index])
    return int(ss.generate_state(1)[0]) & 0x7FFFFFFF


def check_rng(seed: int, tag: int = TAG_CHECK) -> np.random.Generator:
    """The generator of stream `tag` (the checked images, or with
    TAG_TILES their tiles) of a run seeded `seed`."""
    return np.random.default_rng([_entropy(seed), tag])


def percentile(values, q: float) -> float:
    """The q-th percentile of all `values` (linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def window_rate(n_images: int, samples_per_image: int,
                window_s: float) -> float:
    """Pixel samples a second over the whole window, in M samples/s."""
    return n_images * samples_per_image / window_s / 1e6


def process_start_wall() -> float:
    """The wall-clock time (time.time()) at which this process started,
    from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


class Reservoir:
    """A uniform sample of `k` of a stream of items, drawn from `rng`
    (reservoir sampling): keeps references, copies nothing."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def _cache_dirs(root: Path) -> None:
    """Kernel build caches inside the checkout, at fixed paths (the
    program's nvcc output already lives in its package's `_build/`)."""
    cache = root / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", render_fn=None, log=None,
             marks=()) -> dict:
    """One run of `cell` (from `find_cell`) on `device`. `render_fn`
    replaces the adapter's `render(scene, cfg, stats)` (the tests plant
    faults with it); `marks` are the (phase, wall time) pairs of set-up
    before this call. Returns the result object."""
    import torch

    from . import adapter, check, opcount
    from . import trace as trace_mod
    from .reference import megakernel as rmk
    from .reference import render as rrender

    t_proc = process_start_wall()
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    conf, mix = cell["config"], cell["traffic"]
    nx, ny = int(conf["nx"]), int(conf["ny"])
    spp = int(mix.get("spp", conf["spp"]))
    depth = int(conf["max_depth"])
    spl = int(mix["samples_per_launch"])
    render_fn = render_fn or adapter.render

    def cfg_of(s):
        return adapter.render_config(nx, ny, spp, depth, spl, s, device)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    marks = list(marks) + [("the program and the reference", time.time())]
    if device != "cpu":
        torch.cuda.init()
        sync()
    marks.append(("device", time.time()))
    scene = make_scene(cell, nx / ny)
    knobs = adapter.plan_knobs(scene, cfg_of(0))
    marks.append(("scene and plan", time.time()))
    # set-up: every shape of the mix (each launch size) at least once
    w_images = int(mix.get("warmup_images", 1))
    w_seconds = float(mix.get("warmup_seconds", 0.0))
    t_w, i = time.perf_counter(), 0
    while i < w_images or time.perf_counter() - t_w < w_seconds:
        render_fn(scene, cfg_of(image_seed(seed, TAG_WARM, i)), None)
        sync()
        i += 1
        if i == 1:
            marks.append(("first image", time.time()))
    marks.append((f"warm-up ({i} images)", time.time()))
    log("setup: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), a in
        zip(marks, [t_proc] + [m[1] for m in marks[:-1]])))
    # the objects of set-up are never collected again: no collection
    # walks them inside the window
    gc.collect()
    gc.freeze()

    stats = adapter.Counters() if trace else None
    n_tiles = -(-nx * ny // (knobs["T"] // knobs["slots_per_pixel"]))
    chk = conf["check"]
    keep = Reservoir(int(chk["images"]), check_rng(seed))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    times = []
    t_setup = time.time() - t_proc
    w0 = time.perf_counter()
    while not times or time.perf_counter() - w0 < seconds:
        s = image_seed(seed, TAG_IMAGE, len(times))
        t0 = time.perf_counter()
        img = render_fn(scene, cfg_of(s), stats)
        sync()
        times.append(time.perf_counter() - t0)
        keep.offer((s, img))
    window_s = time.perf_counter() - w0
    if prof is not None:
        t_x = time.perf_counter()
        prof.__exit__(None, None, None)
        log(f"trace: stopped in {time.perf_counter() - t_x:.3f} s")
    peak = (torch.cuda.max_memory_allocated() if device != "cpu"
            else 0)
    n_img = len(times)

    metrics, dev_extra, breakdown = {}, {}, None
    e2e = {m["name"]: m for m in cell["end_to_end"]}
    if not trace:
        values = {
            "pixel_samples_per_s": window_rate(n_img, nx * ny * spp,
                                               window_s),
            "image_p95_ms": percentile(times, 95) * 1e3,
            "setup_s": t_setup}
        for name, m in e2e.items():
            metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        win = trace_mod.from_profiler(prof)
        _, rplan = rmk.make_plan(scene, nx, ny, min(spl, spp),
                                 max_depth=depth, **knobs)
        ctx = {"window": win, "window_s": window_s, "images": n_img,
               "pixel_samples": n_img * nx * ny * spp,
               "launches": n_img * len(rrender.launches(spp, spl)),
               "segments": float(stats.segments), "plan": rplan,
               "n_tiles": n_tiles,
               "table_bytes": _table_bytes(scene, rplan),
               "opcount": opcount, "patterns": trace_mod}
        for m in cell["per_layer"]:
            v = metric_reader(m["name"], cell["pkg"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_extra = {"busy_s": win.busy_seconds(), "window_s": window_s}
        breakdown = {"device_ops": win.top_device_ops(),
                     "idle_gaps": win.idle_gaps()}
        log(f"trace: {len(win.device)} device and {len(win.host)} host "
            f"events read in {time.perf_counter() - t_x:.3f} s")
        del prof, win

    # the output check, once the window has closed and the peak is read
    rng = check_rng(seed, TAG_TILES)
    bad = total = failed = 0
    t_chk = time.perf_counter()
    jobs, pixes = [], []
    for s, _ in keep.items:
        tiles = rrender.sample_tiles(n_tiles, int(chk["tiles"]), rng)
        jobs.append((s, tiles))
        pixes.append(rrender.tile_pixels(scene, nx, ny, min(spl, spp),
                                         tiles, knobs))
    refs = rrender.render_tiles(scene, nx, ny, spp, depth, spl, jobs, knobs,
                                device)
    for (_, img), ref, pix in zip(keep.items, refs, pixes):
        b, n = check.mismatches(img, ref, pix)
        failed += b > int(chk["limits"]["mismatch_share"] * n)
        bad, total = bad + b, total + n
    readings = {"mismatch_share": bad / max(total, 1)}
    correct, lines = check.judge(readings, chk["limits"])
    log(f"check: {len(keep.items)} images, {total} channels, "
        f"{time.perf_counter() - t_chk:.3f} s")

    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded that no run may hold: {found}")
    result = {"correct": correct, "attempted": n_img, "failed": failed,
              "metrics": metrics,
              "device": _device(device, int(cell["workload"]["chips"]),
                                peak, dev_extra)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": readings.get(name), "limit": lim}
                        for name, lim in chk["limits"].items()}
    result["_lines"] = lines
    result["_times"] = times
    return result


def _table_bytes(scene, plan) -> int:
    """Bytes of the scene's tables a launch reads (the reference's)."""
    from .reference import megakernel as rmk
    tabs = rmk.build_tables_cached(scene, plan.SB, plan.sg)
    return int(sum(a.nbytes for a in tabs[:6]))


def _device(device: str, chips: int, peak: int, extra: dict) -> dict:
    import torch
    if device == "cpu":
        kind, platform = "cpu", "cpu"
    else:
        kind, platform = torch.cuda.get_device_name(0), "gpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(peak), **extra}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    marks = [("interpreter and harness", time.time())]
    args = parse(argv)
    try:
        _cache_dirs(ROOT)
        cell = find_cell(load_spec(ROOT), args.workload, ROOT)
        import torch
        marks.append(("import torch", time.time()))
        chips = int(cell["workload"]["chips"])
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False: the "
                             "benchmark runs on an NVIDIA GPU only")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} GPUs, "
                             f"{torch.cuda.device_count()} present")
        marks.append(("CUDA driver check", time.time()))
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          marks=marks)
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    lines = result.pop("_lines")
    times = np.asarray(result.pop("_times")) * 1e3
    print("window: image ms quartiles "
          + " ".join(f"{q:.3f}" for q in np.percentile(times, [0, 25, 50,
                                                               75, 100])),
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0
