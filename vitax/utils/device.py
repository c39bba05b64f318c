"""What the program knows about the accelerator it measures on.

Measurement entry points (``chip_smoke.py``, ``bench.py``) call
``require_gpu`` first: a timing taken on any other backend is not a device
number, so they refuse to run rather than fall back. ``device_peaks`` is
the table of published peaks that roofline shares divide by; a device that
is not in the table is an error, not a default.
"""

from __future__ import annotations

import subprocess

import jax

# device_kind -> published dense peaks (NVIDIA H100 SXM data sheet; the
# rates assume the card's full 700 W power limit).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12,
        "int8_ops_per_s": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


class NoAcceleratorError(RuntimeError):
    """JAX found no GPU to run on."""


def require_gpu() -> jax.Device:
    """The first JAX device, which must be a GPU."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise NoAcceleratorError(
            f"JAX found no GPU (first device: {device.platform} "
            f"{device.device_kind!r}); this entry point measures the GPU only"
        )
    return device


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def device_peaks(kind: str) -> dict:
    """Published peaks for ``kind`` (a ``device_kind`` string)."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to "
            "vitax.utils.device.DEVICE_PEAKS with its source"
        ) from None


def nvidia_smi_name_power() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
