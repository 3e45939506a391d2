"""The device the port's entry points run on, and its free memory (the
counterparts of ``parallax_tpu/utils/hw.py``'s device queries).

Entry points run on ``cuda:0`` unless the caller asks for another device;
there is no fallback to the CPU when no card is present.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None = ``cuda:0``. A CUDA device
    when none is available raises (no fallback to the CPU)."""
    device = torch.device(device if device is not None else "cuda:0")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"parallax_tpu_torch runs on {device} and no CUDA device is "
            "available; pass device=\"cpu\" (--device cpu) to run the plain "
            "PyTorch path on the CPU"
        )
    return device


def device_free_memory_bytes(device, fraction: float = 0.9) -> int:
    """Usable bytes on ``device`` for KV-cache budgeting: a fraction of what
    ``torch.cuda.mem_get_info`` reports free on a card (the JAX package
    reads its device's ``memory_stats``), of the host's available memory
    on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
    else:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return int(free * fraction)
