"""What a measurement ran on: JAX's device and the card's own report.

Measurement entry points (bench.py, chip_smoke.py, __graft_entry__.py) call
require_gpu first: a number taken on another platform is not a GPU number,
so there is no fallback to the CPU.
"""

from __future__ import annotations

import subprocess


def device_record():
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(what):
    """Exit with a message naming the platform unless JAX's default
    device is a GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"{what}: needs a GPU, but JAX's default platform is "
            f"{rec['platform']!r} ({rec['kind']}); refusing to run "
            f"without one")
    return rec


def nvidia_smi_name_power():
    """The lines of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` (one per card), or None if it cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
