"""The port's measurement instruments: the sweep twin (K8) and the
dot-formulation microbenchmark (K9), each with its CLI
(`python -m raytracingweekend_tpu_torch.tools.<name>`)."""
from __future__ import annotations

import subprocess
import time

import torch


def card_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them, for rows
    measured on `device`; "cpu (plain version)" for the CPU. Raises on a
    CUDA device when none is present."""
    if torch.device(device).type != "cuda":
        return "cpu (plain version)"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tools run on the card by "
                           "default; pass --device cpu for the plain "
                           "version")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn, device) -> tuple:
    """One call of fn() in ms, and its result: CUDA events around it on
    the card, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out
