"""Terminal boot banner (port of ``parallax_tpu/utils/banner.py``).

A static, pipe-safe banner: it prints once with the version and a device
line (the card's name) and stays plain text when stdout is not a TTY.
"""

from __future__ import annotations

import os
import sys
import threading

_ART = r"""
                           _ _              _
 _ __   __ _ _ __ __ _ ___| | | __ ___  __ | |_ _ __  _   _
| '_ \ / _` | '__/ _` (_-< | |/ _` \ \/ / | __| '_ \| | | |
| |_) | (_| | | | (_| /__/ | | (_| |>  <  | |_| |_) | |_| |
| .__/ \__,_|_|  \__,_|___|_|_|\__,_/_/\_\  \__| .__/ \__,_|
|_|   pipeline-parallel LLM serving on PyTorch + CUDA |_|
"""


def banner(device_line: str | None = None) -> str:
    from parallax_tpu_torch.utils.version_check import get_current_version

    lines = [_ART.rstrip("\n"), f"  v{get_current_version()}"]
    if device_line:
        lines.append(f"  {device_line}")
    text = "\n".join(lines) + "\n"
    if sys.stdout.isatty() and os.environ.get("NO_COLOR") is None:
        return f"\x1b[36m{text}\x1b[0m"
    return text


def print_banner(device_line: str | None = None) -> None:
    sys.stdout.write(banner(device_line))


def device_line(device) -> str:
    """The banner's device line: the card's name for a CUDA device, the
    device string otherwise. Reads no CUDA state when the device is the
    CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(dev)
    return str(dev)


def boot(device, probe: bool = True) -> None:
    """What ``serve`` and ``run`` print first: the banner with the device
    line, and (unless ``PARALLAX_TPU_NO_VERSION_CHECK`` is set or
    ``probe`` is False) the release probe on a daemon thread, so it never
    delays boot."""
    print_banner(device_line(device) if device is not None else None)
    if not probe or os.environ.get("PARALLAX_TPU_NO_VERSION_CHECK"):
        return

    def _version_hint():
        from parallax_tpu_torch.utils.version_check import (
            check_latest_release,
        )

        hint = check_latest_release()
        if hint:
            print(hint, flush=True)

    threading.Thread(target=_version_hint, daemon=True,
                     name="version-check").start()
