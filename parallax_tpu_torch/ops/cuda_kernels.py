"""Build, load and count the port's hand-written CUDA kernels.

The sources live in ``parallax_tpu_torch/csrc/*.cu`` and export a plain C
interface. At first use every ``.cu`` is compiled by its own ``nvcc`` (all
started together) for ``sm_90a`` and the objects are linked into one shared
library under ``parallax_tpu_torch/_build/`` (git-ignored), named by a hash
of the sources and flags so an edit rebuilds. The library is loaded with
``ctypes``; each C entry returns ``cudaGetLastError()`` and :func:`check`
raises on a non-zero code.

``LAUNCHES`` holds one plain integer per kernel; a wrapper adds one
(``count``) exactly where it launches its kernel, so a run can show that
the main path went through the kernels (``reset_launches`` /
``launches``). A CUDA graph launches its captured kernels without running
the wrappers, so the engine records each graph's count delta at capture
and adds it at every replay (``add_launches``). A capture tallies its own
thread's launches (``tally``), so engines that serve from other threads of
the same process keep counting meanwhile.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
# ``-split-compile=0``: each source's device functions are optimized in
# parallel on every core (the attention sources instantiate A1 / A2 / A9
# for three head dims, two types and two group tilings each).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-split-compile=0",
]

KERNELS = ("kv_append", "gqa_prefill", "gqa_decode", "gqa_attend",
           "sample_topk", "grouped_gemm", "mla_decode", "mla_attend",
           "indexer_fused", "indexer_scores", "gumbel_rows", "quant_linear",
           "grouped_gemm_q")
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
# The calling thread's open tally: (counts, also into LAUNCHES).
_tally = threading.local()

_lib = None
_lock = threading.Lock()
# Seconds the last build took (0.0 when the library was already built).
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # k, v, cache, slots, t, hkv, d, total_slots, dtype, stream
    "pk_kv_append": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _P],
    # q, cache, out, kv_lens, page_indices, cu_q_lens, num_seqs, sinks,
    # scratch, t, s, hq, hkv, d, page, pps, q_tile, num_splits, window,
    # sm_scale, soft_cap, dtype, stream
    "pk_gqa_prefill": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _I, _P],
    # q, k_new, v_new, cache, out, kv_lens, page_indices, slots, sinks,
    # scratch, s, hq, hkv, d, page, pps, num_splits, total_slots, window,
    # sm_scale, soft_cap, dtype, stream
    "pk_gqa_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _L, _I, _F, _F, _I, _P],
    # q, cache, out, kv_lens, page_indices, sinks, scratch,
    # s, hq, hkv, d, page, pps, num_splits, window, sm_scale, dtype, stream
    "pk_gqa_attend": [_P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # logits, gumbel, temperature, top_k, out, workspace, s, v, chunks,
    # chunk_len, stream
    "pk_sample_topk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # lhs, rhs, group_offsets, out, m, n, k, e, variant, stream
    "pk_grouped_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q_latent, q_pe, latent_new, k_pe_new, cache, out, kv_lens,
    # page_indices, slots, scratch, s, hq, r, dr, page, pps, num_splits,
    # total_slots, sm_scale, dtype, stream
    "pk_mla_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _L, _F, _I, _P],
    # q_latent, q_pe, cache, out, kv_lens, page_indices, scratch,
    # s, hq, r, dr, page, pps, num_splits, sm_scale, dtype, stream
    "pk_mla_attend": [_P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, weights, k_new, cache, scores, kv_lens, page_indices, slots,
    # s, hi, d, page, pps, blocks, total_slots, reduce, sm_scale, dtype,
    # stream
    "pk_indexer_fused": [_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _L, _I, _F, _I, _P],
    # q, weights, cache, scores, kv_lens, page_indices,
    # s, hi, d, page, pps, blocks, total_slots, reduce, sm_scale, dtype,
    # stream
    "pk_indexer_scores": [_P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _L, _I, _F, _I, _P],
    # seeds, steps, out, bits, base_seed, s, v, stream
    "pk_gumbel_rows": [_P, _P, _P, _P, _L, _I, _I, _P],
    # x, qweight, scales, biases, out, m, n, k, g, out_dtype, variant, stream
    "pk_quant_linear": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # lhs, qweight, scales, biases, group_offsets, out, m, n, k, e, g,
    # variant, stream
    "pk_grouped_gemm_q": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith(".cu")
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(os.listdir(CSRC)):
        if path.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, path), "rb") as f:
                h.update(path.encode() + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if needed; returns the shared library's path.
    ``verbose`` passes ``-Xptxas -v`` and prints the compiler's output."""
    global last_build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libparallax_kernels_{_digest()}.so")
    if os.path.exists(lib_path):
        last_build_seconds = 0.0
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(
            BUILD_DIR, os.path.basename(src)[:-3] + f".{os.getpid()}.o"
        )
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    last_build_seconds = time.perf_counter() - t0
    from parallax_tpu_torch.obs.device import note_build

    note_build("kernel_build", {"lib": os.path.basename(lib_path)},
               last_build_seconds)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Once loaded it is
    returned without taking the lock."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


# torch's private raw-stream getter, looked up once: torch._inductor's
# launchers read the stream through it. Builds without it (CPU-only ones,
# or a torch that renames it) take the public lookup in ``stream_of``.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, read
    without building a ``torch.cuda.Stream`` object where torch allows it
    (that costs a few microseconds of every wrapper's enqueue)."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    """0 = float32, 1 = bfloat16 (the two cache types the kernels take)."""
    return {torch.float32: 0, torch.bfloat16: 1}[t.dtype]


def count(name: str) -> None:
    """One launch of ``name``'s kernel (its wrapper calls this where it
    launches). It goes into ``LAUNCHES`` and into the calling thread's
    tally, if one is open."""
    open_tally = getattr(_tally, "open", None)
    if open_tally is not None:
        counts, into_launches = open_tally
        counts[name] = counts.get(name, 0) + 1
        if not into_launches:
            return
    LAUNCHES[name] += 1


@contextlib.contextmanager
def tally(into_launches: bool = True):
    """Count the calling thread's launches in a dict of their own while the
    block runs (another thread's launches go to ``LAUNCHES`` alone).
    ``into_launches=False`` keeps them out of ``LAUNCHES``: a graph
    capture's launches run only when it replays."""
    counts: dict[str, int] = {}
    outer = getattr(_tally, "open", None)
    _tally.open = (counts, into_launches)
    try:
        yield counts
    finally:
        _tally.open = outer


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


def add_launches(delta: dict[str, int], times: int = 1) -> None:
    """Count ``times`` replays of a CUDA graph whose capture ran the
    wrappers ``delta`` times each."""
    for k, n in delta.items():
        LAUNCHES[k] += n * times


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device and contiguity checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
