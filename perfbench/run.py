"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload codebook.fit --seed 7 \
        --seconds 40 --trace 0

Set-up (imports, the kernels' load, data made on the card from the seed,
one warm-up job) is timed as ``setup_s``; then the cell's loop runs for
``--seconds``; with ``--trace 1`` a few more jobs run under
``torch.profiler`` for the per-layer metrics.  The outputs are judged by
the plain reference after the window.  The last line of standard output is
the result as one JSON object.  Without a CUDA card it exits 3 and prints
no result.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    # the program's build and kernel caches, at fixed paths in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if sys.path[2:3] == [str(ROOT / "perfbench")]:
        del sys.path[2]
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
