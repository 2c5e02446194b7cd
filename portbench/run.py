"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. Prints one JSON result line last on standard
output; exits non-zero with no result where it cannot run (no NVIDIA GPU,
fewer than the cell's GPUs, an unknown cell, the program missing).
"""
import sys

if __package__ in (None, ""):
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import main
else:
    from .harness import main

if __name__ == "__main__":
    sys.exit(main())
