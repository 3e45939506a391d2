"""Kernel-selection policy, mirroring ``parallax_tpu/ops/kernel_select.py``.

- ``cuda_available()`` — is there a CUDA device of compute capability 9.0
  (Hopper, the only target the ``sm_90a`` kernels are built for)?
- ``resolve_decode_fused(flag, device)`` / ``resolve_prefill_fused`` — the
  engine-level choice between the fused CUDA kernels and the split path,
  with the JAX package's tri-state: ``None`` = fused kernels when the
  engine's device is CUDA; ``True`` = fused kernels, and an error on a CPU
  device; ``False`` = the split path.
  There is no silent downgrade: a CUDA device that is not Hopper raises.
- ``resolve_use_kernels(flag, device)`` — the split path's per-op choice
  between its kernels and plain PyTorch (the JAX package's
  ``resolve_use_pallas``): an explicit flag wins, ``None`` means kernels
  when the op's tensors are on CUDA. ``False`` is the only way to get the
  plain split path on the card.

The impl labels are the canonical names in ``kernel_dispatch_summary()``.
"""

from __future__ import annotations

import torch

# Canonical impl labels (the JAX package's are pallas-fused / pallas-split /
# xla).
IMPL_FUSED = "cuda-fused"
IMPL_SPLIT = "cuda-split"
IMPL_TORCH = "torch"

HOPPER = (9, 0)


def cuda_available() -> bool:
    """True when a CUDA device with compute capability 9.0 is visible."""
    return (
        torch.cuda.is_available()
        and torch.cuda.get_device_capability(0) == HOPPER
    )


def _check_kernel_device(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"{what}=True needs a CUDA device, got {device}; pass "
            f"{what}=False (or None) for the plain PyTorch path"
        )
    cap = torch.cuda.get_device_capability(device)
    if cap != HOPPER:
        raise RuntimeError(
            f"{what}: CUDA device {device} has compute capability {cap}; "
            f"the port's kernels are built for sm_90a (Hopper) only — pass "
            f"{what}=False for the plain PyTorch path"
        )


def _resolve(flag: bool | None, device: torch.device, what: str) -> bool:
    device = torch.device(device)
    if flag is None:
        flag = device.type == "cuda"
    if flag:
        _check_kernel_device(device, what)
    return bool(flag)


def resolve_decode_fused(flag: bool | None, device) -> bool:
    """Engine-level fused-decode choice (see the module docstring)."""
    return _resolve(flag, device, "decode_fused")


def resolve_prefill_fused(flag: bool | None, device) -> bool:
    """Engine-level fused-prefill choice (see the module docstring)."""
    return _resolve(flag, device, "prefill_fused")


def resolve_use_kernels(flag: bool | None, device) -> bool:
    """Per-op split-kernel choice: an explicit flag wins, None = kernels
    when the tensors are on CUDA."""
    if flag is None:
        return torch.device(device).type == "cuda"
    return bool(flag)


def decode_attn_impl(fused: bool, use_kernels: bool | None, device) -> str:
    """The canonical impl label for a stage's decode attention path: the
    fused kernels, the split kernels (``use_kernels`` resolved against the
    engine's device), or the plain PyTorch path."""
    if fused:
        return IMPL_FUSED
    if resolve_use_kernels(use_kernels, device):
        return IMPL_SPLIT
    return IMPL_TORCH


def prefill_attn_impl(fused: bool, use_kernels: bool | None, device) -> str:
    """The canonical impl label for a stage's prefill attention path."""
    return decode_attn_impl(fused, use_kernels, device)
