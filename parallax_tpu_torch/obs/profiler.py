"""Device traces on demand: ``torch.profiler`` behind the JAX package's
``jax.profiler.start_trace`` / ``stop_trace`` shape (port-only module).

``POST /profile/start`` on a frontend and the worker's ``PROFILE`` RPC
start one process-wide trace and ``/profile/stop`` ends it, writing a
Chrome trace-event JSON (``trace-<pid>-<ms>.json``) into the requested
directory. The session records CPU ops and, on a CUDA build with a card,
the device's kernels (CUPTI), those inside CUDA-graph replays included.

Both calls must run on the thread that steps the device: a profiler
started on one thread and stopped on another loses that thread's events,
and the serving paths' rule is that only the step thread makes CUDA
calls. Callers post them there (``LocalRunner.call``, the worker's step
inbox) and wait for the reply.
"""

from __future__ import annotations

import os
import tempfile
import time

from parallax_tpu_torch.analysis.sanitizer import make_lock

# Where a trace goes when the caller names no directory.
DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "parallax-profile")

_lock = make_lock("obs.profiler")
_session: tuple | None = None   # (profiler, out_dir) while tracing


def start_trace(out_dir: str) -> None:
    """Start the process's trace (step thread). Raises RuntimeError while
    one runs."""
    global _session
    import torch

    with _lock:
        if _session is not None:
            raise RuntimeError("profiler already running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        _session = (prof, str(out_dir))


def stop_trace() -> str:
    """End the trace (step thread) and write it; returns the JSON's path.
    Raises RuntimeError when none runs."""
    global _session
    with _lock:
        if _session is None:
            raise RuntimeError("profiler not running")
        prof, out_dir = _session
        _session = None
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(path)
    return path
