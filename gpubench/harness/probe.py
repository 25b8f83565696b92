"""What the card and its host were doing: printed beside every run.

``nvidia-smi`` gives the card's name, power limit, clocks and draw; a
fixed numpy workload, which touches nothing of the program, times the
host's CPU, since a one-card machine shares its host's cores.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np

SMI_FIELDS = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
              "clocks.mem,temperature.gpu")


def smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not available ({type(exc).__name__})"
    return out.stdout.strip() or f"not available (rc {out.returncode})"


def host_ms() -> float:
    """Milliseconds of a fixed numpy workload: 8 products of 256×256
    float64 matrices and a sort of 2·10⁵ values."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 256))
    v = rng.standard_normal(200_000)
    t0 = time.perf_counter()
    for _ in range(8):
        a = a @ a
        a /= np.abs(a).max()
    np.sort(v)
    return (time.perf_counter() - t0) * 1e3
