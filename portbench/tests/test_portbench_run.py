"""The harness's run: the window's statistics over every image, the
seeds, and the refusal to run without a card."""
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny_cell

from portbench import harness


def test_rate_and_p95_are_over_every_image_of_the_window():
    cell = tiny_cell("cornell_box.converge")
    cell["end_to_end"] = harness.load_spec()["end_to_end"]
    nx, ny, spp = (cell["config"][k] for k in ("nx", "ny", "spp"))
    waits = [0.004, 0.012, 0.002, 0.030, 0.006] * 3
    seen = []

    def render_fn(scene, cfg, stats=None):
        if len(seen) >= 1:              # after the one warm-up image
            time.sleep(waits[(len(seen) - 1) % len(waits)])
        seen.append(cfg.seed)
        return torch.zeros((ny, nx, 3))

    res = harness.run_cell(cell, 11, 0.15, False, device="cpu",
                           render_fn=render_fn, log=lambda *a: None)
    n = res["attempted"]
    times = res["_times"]
    assert n == len(times) == len(seen) - 1 >= 5
    assert all(t >= waits[i % len(waits)] for i, t in enumerate(times))
    m = res["metrics"]
    rate = m["pixel_samples_per_s"]["value"]
    # whole images over the whole window, which holds every image's time
    window = n * nx * ny * spp / rate / 1e6
    assert sum(times) <= window <= 1.5 * sum(times) + 0.05
    assert m["image_p95_ms"]["value"] == pytest.approx(
        np.percentile(np.asarray(times) * 1e3, 95))
    assert not res["correct"]           # a black image is not the box


def test_percentile_and_rate_helpers():
    assert harness.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert harness.window_rate(3, 1_000_000, 2.0) == 1.5


def test_seeds_are_deterministic_and_take_large_values():
    big = 2 ** 31 + 977
    a = [harness.image_seed(big, harness.TAG_IMAGE, i) for i in range(4)]
    assert a == [harness.image_seed(big, harness.TAG_IMAGE, i)
                 for i in range(4)]
    assert len(set(a)) == 4 and all(0 <= s < 2 ** 31 for s in a)
    assert a != [harness.image_seed(big + 1, harness.TAG_IMAGE, i)
                 for i in range(4)]
    assert harness.image_seed(-5, 1, 0) >= 0


def test_reservoir_keeps_a_uniform_sample():
    counts = np.zeros(10)
    for s in range(2000):
        r = harness.Reservoir(2, np.random.default_rng(s))
        for i in range(10):
            r.offer(i)
        counts[r.items] += 1
    assert counts.min() > 300 and counts.max() < 500


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", *args], cwd=cwd,
        capture_output=True, text=True, timeout=120)


def test_run_without_a_card_exits_with_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT, "--workload", "book1_final.converge", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "GPU" in p.stderr


def test_run_in_a_folder_with_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path, "--workload", "cornell_box.converge", "--seed", "2",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_unknown_cell_exits_with_an_error():
    p = _run(ROOT, "--workload", "no_such.cell", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and not p.stdout.strip()


def test_result_line_is_one_json_object_with_the_checks_last():
    cell = tiny_cell("book1_final.converge")
    res = harness.run_cell(cell, 2 ** 31 + 5, 0.01, False, device="cpu",
                           log=lambda *a: None)
    lines = res.pop("_lines")
    assert len(res.pop("_times")) == res["attempted"]
    assert list(res)[-1] == "checks" and lines
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res)
