"""The device the port's entry points run on, its free memory, and the
hardware summary a worker ships to the global scheduler on join (the
counterparts of ``parallax_tpu/utils/hw.py``).

Entry points run on ``cuda:0`` unless the caller asks for another device;
there is no fallback to the CPU when no card is present.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from parallax_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Peak specs per device: (dense bf16 TFLOPS, memory GiB, memory GB/s,
# interconnect GB/s). The last slot is the JAX package's ICI figure; for
# the H100 it holds NVLink's (NVIDIA's H100 SXM datasheet: 900 GB/s of
# NVLink bandwidth). The ``cpu`` entry is the JAX package's host fallback,
# kept equal so that tests allocate the same way in both packages.
DEVICE_DB: dict[str, tuple[float, float, float, float]] = {
    "h100": (989.0, 80.0, 3350.0, 900.0),
    "cpu": (1.0, 8.0, 50.0, 10.0),
}


@dataclasses.dataclass
class HardwareInfo:
    """Per-node hardware summary shipped to the global scheduler on join.
    The field names are the JAX package's: the dict crosses the wire in
    ``node_join``."""

    device_kind: str          # e.g. "h100"
    num_chips: int            # devices this worker serves on
    tflops_bf16: float        # per device
    hbm_gib: float            # per device
    hbm_gbps: float           # per device
    ici_gbps: float

    @property
    def total_tflops(self) -> float:
        return self.tflops_bf16 * self.num_chips

    @property
    def total_hbm_bytes(self) -> int:
        return int(self.hbm_gib * self.num_chips * (1 << 30))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareInfo":
        return cls(**d)


def _device_kind_key(name: str) -> str:
    """Map a device name (``torch.cuda.get_device_name``) to a DEVICE_DB
    key. Cards other than the H100 have no entry: they report the H100's
    peak figures (with a warning) and their own memory capacity."""
    if name == "cpu":
        return "cpu"
    if "h100" not in name.lower():
        logger.warning("no spec entry for %r: reporting the H100's peak "
                       "figures", name)
    return "h100"


def detect_hardware(device=None) -> HardwareInfo:
    """The summary of the one device a worker serves on (None = ``cuda:0``).
    On a card the capacity is its ``total_memory`` (the JAX package reads
    its device's ``bytes_limit``)."""
    device = resolve_device(device)
    if device.type != "cuda":
        kind = "cpu"
        tflops, hbm, bw, ici = DEVICE_DB[kind]
    else:
        kind = _device_kind_key(torch.cuda.get_device_name(device))
        tflops, _hbm, bw, ici = DEVICE_DB[kind]
        hbm = torch.cuda.get_device_properties(device).total_memory / (1 << 30)
    return HardwareInfo(device_kind=kind, num_chips=1, tflops_bf16=tflops,
                        hbm_gib=hbm, hbm_gbps=bw, ici_gbps=ici)


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


def host_available_memory_bytes() -> int:
    """Host DRAM available for the KV offload tier (0 when unknown):
    Linux ``MemAvailable`` rather than MemFree, so page cache the kernel
    would drop under pressure counts toward the tier budget."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def default_host_cache_bytes(fraction: float = 0.5,
                             override: int | None = None,
                             device=None) -> int:
    """Host-KV-tier budget: the operator's explicit value when given,
    otherwise ``fraction`` of available DRAM when the engine runs on a
    card (``device`` None = ``cuda:0``), so the tier never drives the
    host into swap. 0 (tier off) on the CPU or when availability cannot
    be read: CPU runs configure the budget explicitly. The single policy
    point for serve and swarm workers."""
    if override is not None:
        return override
    if torch.device(device if device is not None else "cuda:0").type \
            != "cuda":
        return 0
    return int(host_available_memory_bytes() * fraction)


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
