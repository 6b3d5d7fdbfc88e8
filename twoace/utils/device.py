"""What ran a measurement: JAX's view of the device and the card's own
``nvidia-smi`` line (name and power limit).

A card set below its maximum power limit runs slower under load, so every
number a measurement script prints is printed beside that line.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List

import jax

#: the query whose output every measurement is printed beside
NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


def parse_nvidia_smi(text: str) -> List[Dict[str, str]]:
    """Parse ``name, power.limit`` CSV lines, one per card, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``.  Raises on a line without a
    comma-separated limit."""
    cards = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append({"name": name.strip(), "power_limit": limit.strip()})
    if not cards:
        raise ValueError("nvidia-smi listed no card")
    return cards


def query_nvidia_smi() -> str:
    """Raw ``nvidia-smi`` output of :data:`NVIDIA_SMI_QUERY`."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout


def require_gpu() -> None:
    """Fail unless JAX's default backend is a GPU: a measurement never
    falls back to the CPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r}; this "
            "measurement runs only on a GPU")


def jax_device() -> Dict[str, object]:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def describe_devices() -> Dict[str, object]:
    """JAX's device triple plus each card's ``nvidia-smi`` name and limit."""
    return {"device": jax_device(),
            "gpu": parse_nvidia_smi(query_nvidia_smi())}
