"""The accelerator a measurement runs on: a gate that accepts only GPUs
(no CPU run is ever reported under a GPU's name), and each card's name and
power limit as nvidia-smi reports them."""

from __future__ import annotations

import subprocess
from typing import List


def require_gpus(count: int = 1):
    """jax.devices(), if they are at least ``count`` GPUs; otherwise
    SystemExit naming what JAX found."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(
            f"needs {count} GPU(s); JAX found {len(devs)} x "
            f"{devs[0].platform} ({devs[0].device_kind})")
    return devs


def name_and_power_limit() -> List[str]:
    """One 'name, power.limit' line per card, verbatim from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()
