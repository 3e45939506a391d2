"""The compilation-cache directory and the compile observatory's hookup
(port of ``parallax_tpu/utils/compile_cache.py``).

The port's compiled programs are two shared libraries: the hand-written
CUDA kernels (``ops/cuda_kernels.py``, nvcc) and the native radix cache
(``native/__init__.py``, g++). Each is built at first use into one
directory, named by a digest of its sources and flags, so a later process
pointed at the same directory loads it instead of paying the build again
(the JAX package's persistent XLA cache plays this part there). The
serving entry points (``serve``, ``generate``, ``join``) call
:func:`enable_compilation_cache` before anything builds.

Compile observability is the builds' own: each real build (not a cache
hit) reports through ``obs/device.py::note_build`` to the compile
observatory (``parallax_xla_compiles_total{program=kernel_build |
native_build}``) and the goodput ledger's ``compile`` bucket;
:func:`register_compile_counter` binds that observatory to the registry.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_OFF = ("off", "0", "none", "disabled", "")

_lock = make_lock("utils.compile_cache")
_active_path: str | None = None
_counter_registered = False


def _point_builds(path: str) -> None:
    """Both libraries build into (and load from) ``path``."""
    from parallax_tpu_torch import native
    from parallax_tpu_torch.ops import cuda_kernels

    cuda_kernels.BUILD_DIR = path
    native.BUILD_DIR = path


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Point the kernel and native builds at a cache directory and return
    it (None only when the directory cannot be made). Never raises:
    cache trouble must not take serving down.

    ``path`` resolution: an explicit argument wins; else the
    ``PARALLAX_TPU_COMPILE_CACHE`` variable; else the package's
    ``_build/``. ``"off"`` (or ``"0"`` / ``"none"`` / ``"disabled"`` /
    ``""``) builds into a private temporary directory, removed at exit,
    so nothing is reused across processes."""
    global _active_path
    if path is None:
        path = os.environ.get("PARALLAX_TPU_COMPILE_CACHE", _DEFAULT_DIR)
    try:
        if str(path).lower() in _OFF:
            path = tempfile.mkdtemp(prefix="parallax_build_")
            atexit.register(shutil.rmtree, path, ignore_errors=True)
            logger.info("compilation cache off: private build directory %s",
                        path)
        else:
            path = os.path.abspath(os.path.expanduser(str(path)))
            os.makedirs(path, exist_ok=True)
            logger.info("compilation cache at %s", path)
        _point_builds(path)
    except Exception as e:  # pragma: no cover - filesystem specific
        logger.warning("compilation cache unavailable: %s", e)
        return None
    with _lock:
        _active_path = path
    register_compile_counter()
    return path


def active_cache_dir() -> str | None:
    """The directory :func:`enable_compilation_cache` chose, or None."""
    return _active_path


def register_compile_counter() -> None:
    """Bind the compile observatory, which every real build reports to
    (``note_build``), to the process registry (idempotent; never raises).
    A cache hit builds nothing and so counts nothing: the series measures
    real compile work only."""
    global _counter_registered
    with _lock:
        if _counter_registered:
            return
        _counter_registered = True
    try:
        from parallax_tpu_torch.obs.device import get_device_plane

        get_device_plane().bind_registry()
    except Exception as e:  # pragma: no cover - defensive; obs only
        logger.debug("compile counter unavailable: %s", e)


def build_counts() -> dict[str, int]:
    """Real builds this process made, by library (``kernel_build``,
    ``native_build``), from the compile observatory."""
    from parallax_tpu_torch.obs.device import get_device_plane

    out = {"kernel_build": 0, "native_build": 0}
    for key, n in get_device_plane().compile.compiles.items():
        family = key[0] if isinstance(key, tuple) else key
        if family in out:
            out[family] += int(n)
    return out
