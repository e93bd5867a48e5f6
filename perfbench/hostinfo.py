"""What the run stood on: the card's name, power limit and clocks
(``nvidia-smi`` sampled once a second beside the window), the host's load
average, and the check that no JAX module was loaded."""
from __future__ import annotations

import os
import subprocess
import sys

QUERY = ("name,power.limit,clocks.sm,clocks.mem,clocks.max.sm,power.draw,"
         "temperature.gpu")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Sampler:
    """``nvidia-smi`` sampling once a second while the window runs."""

    def __init__(self):
        self.proc = None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={QUERY}",
                 "--format=csv,noheader,nounits", "-l", "1"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            pass
        self.load_before = os.getloadavg()

    def stop(self) -> list[str]:
        self.load_after = os.getloadavg()
        if self.proc is None:
            return []
        self.proc.terminate()
        out, _ = self.proc.communicate()
        return [line.strip() for line in out.splitlines() if line.strip()]

    def lines(self, samples: list[str]) -> list[str]:
        out = [f"# nvidia-smi ({QUERY}): {s}" for s in samples]
        if not samples:
            out.append("# nvidia-smi: no sample")
        out.append(f"# loadavg before {self.load_before} after "
                   f"{self.load_after}")
        return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
