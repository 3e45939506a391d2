"""Release-freshness check (port of ``parallax_tpu/utils/version_check.py``).

``get_current_version`` reads the installed ``parallax-tpu`` distribution,
then this package's ``version.py``. The latest-release probe asks the URL
that ``PARALLAX_TPU_RELEASES_URL`` names and degrades to None on any
failure within its timeout. Where the JAX module falls back to a public
release API, the port probes nothing unless the variable is set: an
egress-less machine never dials out at boot.
"""

from __future__ import annotations

import json
import os
import urllib.request

RELEASES_URL = os.environ.get("PARALLAX_TPU_RELEASES_URL", "")


def get_current_version() -> str:
    try:
        import importlib.metadata

        return importlib.metadata.version("parallax-tpu")
    except Exception:
        try:
            from parallax_tpu_torch.version import __version__

            return __version__
        except Exception:
            return "unknown"


def get_latest_version(timeout: float = 3.0) -> str | None:
    """Latest published release tag, or None when unreachable (offline,
    rate-limited, air-gapped: all non-fatal by design), or when no
    releases URL is set."""
    if not RELEASES_URL:
        return None
    try:
        with urllib.request.urlopen(RELEASES_URL, timeout=timeout) as resp:
            data = json.loads(resp.read())
        tag = data.get("tag_name") or data.get("name")
        return str(tag).lstrip("v") if tag else None
    except Exception:
        return None


def check_latest_release(log=None) -> str | None:
    """Compare current vs latest; returns an update hint (also logged when
    a logger is passed) or None when up to date or unknown."""
    current = get_current_version()
    latest = get_latest_version()
    if latest is None or current in ("unknown", latest):
        return None
    msg = (
        f"parallax-tpu {current} is behind the latest release {latest}; "
        f"consider upgrading"
    )
    if log is not None:
        log.info("%s", msg)
    return msg
