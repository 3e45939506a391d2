"""The native (C++) cache manager with ctypes bindings (port of
``parallax_tpu/native/__init__.py``; ``radix_cache.cpp`` here is a verbatim
copy of that package's source).

Exposes :class:`NativeRadixPageCache` and :class:`NativePageAllocator`,
drop-in replacements for the pure-Python versions in
``parallax_tpu_torch/runtime``, and :class:`NativeCacheManager`: ONE ABI
crossing per scheduler operation (admit = match + lock + evict + alloc
fused; grow; release = unlock + insert + free fused). It is the default
manager (``runtime.cache_manager.make_cache_manager``); set
``PARALLAX_TPU_NO_NATIVE=1`` (the JAX package's variable, so one setting
governs both) to force the Python one.

The shared library builds with g++ at first use into the git-ignored
``parallax_tpu_torch/_build/``, named by a digest of the source and the
flags (as ``ops/cuda_kernels.py`` names the kernels' library): each
process compiles to a temp file of its own and renames it into place, so
processes building at once never load a half-written library, and nothing is
written beside the source. Hybrid models' linear-state snapshots ride the
tree's slot calls (``radix_attach_slot``, ``radix_detach_lru_slot``,
``radix_take_freed_slots``) and the admit / release calls' slot arguments.
A LoRA request's tokens are XOR-salted per adapter, as the Python
manager's are (``cache_manager.ns_salt``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import time

import numpy as np

from parallax_tpu_torch.analysis.sanitizer import make_lock

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "radix_cache.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_lock = make_lock("native.build")
_lib = None
_build_failed = False
build_error: str | None = None


def library_path(src: str | None = None) -> str:
    """Where the library built from ``src`` (default: ``SRC``) lives."""
    src = src or SRC
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libradix_{h.hexdigest()[:16]}.so")


def build(src: str | None = None) -> str:
    """Compile ``src`` (default: ``SRC``) if its library is missing;
    returns its path. Raises on a failed build."""
    src = src or SRC
    path = library_path(src)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    from parallax_tpu_torch.obs.device import note_build

    note_build("native_build", {"lib": os.path.basename(path)},
               time.perf_counter() - t0)
    return path


_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# The bound entry points: name -> (argtypes, restype).
SIGNATURES = {
    "radix_new": ([_I32], _VP),
    "radix_free": ([_VP], None),
    "radix_num_pages": ([_VP], _I64),
    "radix_match": ([_VP, _I32P, _I64, _I32P, _I64], _I64),
    "radix_lock": ([_VP, _I32P, _I64, _I64, _I32], None),
    "radix_insert": ([_VP, _I32P, _I64, _I32P, _I64, _I32P, _I64], _I64),
    "radix_evict": ([_VP, _I64, _I32P], _I64),
    "radix_reset": ([_VP, _I32P, _I64], _I64),
    "alloc_new": ([_I32, _I32], _VP),
    "alloc_free": ([_VP], None),
    "alloc_num_free": ([_VP], _I64),
    "alloc_take": ([_VP, _I64, _I32P], _I64),
    "alloc_release": ([_VP, _I32P, _I64], None),
    "cache_admit": ([_VP, _VP, _I32P, _I64, _I32, _I32, _I64, _I32P, _I64,
                     _I64P, _I32P], _I64),
    "cache_grow": ([_VP, _VP, _I64, _I32P], _I64),
    "cache_release": ([_VP, _VP, _I32P, _I64, _I64, _I32P, _I64, _I64,
                       _I32, _I64P, _I32P, _I64, _I32P], _I64),
    "radix_attach_slot": ([_VP, _I32P, _I64, _I32], _I32),
    "radix_detach_lru_slot": ([_VP], _I32),
    "radix_take_freed_slots": ([_VP, _I32P, _I64], _I64),
}


def open_library(src: str | None = None):
    """Build (if needed) and load the library of ``src`` with its entry
    points bound. Raises on a failed build."""
    lib = ctypes.CDLL(build(src))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_library():
    """The process's library (built at first use), or None when
    ``PARALLAX_TPU_NO_NATIVE`` is set or the build failed (warned once)."""
    global _lib, _build_failed, build_error
    if os.environ.get("PARALLAX_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            _lib = open_library()
        except Exception as e:
            build_error = f"{type(e).__name__}: {e}"
            logger.warning("native build failed (%s); using Python fallback",
                           e)
            _build_failed = True
        return _lib


def _as_i32(xs) -> np.ndarray:
    return np.ascontiguousarray(xs, dtype=np.int32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeRadixPageCache:
    """ctypes facade matching ``runtime.radix_cache.RadixPageCache``.

    Lock paths are tracked by (token prefix, page count) instead of node
    objects; ``match_prefix`` returns that handle as its second element.
    """

    def __init__(self, page_size: int, on_evict=None, on_evict_slot=None):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.page_size = page_size
        self.on_evict = on_evict
        self.on_evict_slot = on_evict_slot
        self._h = self._lib.radix_new(page_size)

    def _drain_slots(self) -> None:
        """Hand the snapshot slots that eviction or a reset dropped to
        ``on_evict_slot`` (the Python radix calls it at the drop). Without
        a consumer (no hybrid model) it costs no ABI crossing."""
        if self.on_evict_slot is None:
            return
        out = np.empty(64, np.int32)
        while True:
            n = self._lib.radix_take_freed_slots(self._h, _ptr(out), 64)
            for slot in out[:n].tolist():
                self.on_evict_slot(int(slot))
            if n < 64:
                return

    def attach_linear_slot(self, token_ids, slot: int) -> bool:
        tokens = _as_i32(token_ids)
        return bool(self._lib.radix_attach_slot(
            self._h, _ptr(tokens), len(tokens), slot))

    def detach_lru_linear_slot(self):
        slot = int(self._lib.radix_detach_lru_slot(self._h))
        return None if slot < 0 else slot

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.radix_free(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def num_cached_pages(self) -> int:
        return int(self._lib.radix_num_pages(self._h))

    def match_prefix(self, token_ids):
        tokens = _as_i32(token_ids)
        cap = max(1, len(tokens) // self.page_size)
        out = np.empty(cap, np.int32)
        n = self._lib.radix_match(
            self._h, _ptr(tokens), len(tokens), _ptr(out), cap
        )
        pages = out[:n].tolist()
        return pages, (tokens[: n * self.page_size], n)

    def slice_path(self, path, n: int):
        tokens, _ = path
        return (tokens[: n * self.page_size], n)

    def lock(self, path) -> None:
        if not path:
            return
        tokens, n = path
        if n:
            self._lib.radix_lock(self._h, _ptr(tokens), len(tokens), n, 1)

    def unlock(self, path) -> None:
        if not path:
            return
        tokens, n = path
        if n:
            self._lib.radix_lock(self._h, _ptr(tokens), len(tokens), n, -1)

    def insert(self, token_ids, page_ids) -> list[int]:
        tokens = _as_i32(token_ids)
        pages = _as_i32(page_ids)
        dups = np.empty(max(1, len(pages)), np.int32)
        n = self._lib.radix_insert(
            self._h, _ptr(tokens), len(tokens), _ptr(pages), len(pages),
            _ptr(dups), len(dups),
        )
        return dups[:n].tolist()

    def evict(self, num_pages: int) -> list[int]:
        out = np.empty(max(1, num_pages), np.int32)
        n = self._lib.radix_evict(self._h, num_pages, _ptr(out))
        freed = out[:n].tolist()
        if self.on_evict:
            for p in freed:
                self.on_evict(p)
        self._drain_slots()
        return freed

    def reset(self) -> list[int]:
        cap = self.num_cached_pages or 1
        out = np.empty(cap, np.int32)
        n = self._lib.radix_reset(self._h, _ptr(out), cap)
        self._drain_slots()
        return out[:n].tolist()


class NativePageAllocator:
    """ctypes facade matching ``runtime.allocator.PageAllocator``."""

    def __init__(self, num_pages: int, reserve_null_page: bool = True):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.num_pages = num_pages
        self.null_page = 0 if reserve_null_page else -1
        self._h = self._lib.alloc_new(num_pages, int(reserve_null_page))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.alloc_free(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def num_free(self) -> int:
        return int(self._lib.alloc_num_free(self._h))

    def alloc(self, n: int) -> list[int]:
        from parallax_tpu_torch.runtime.allocator import OutOfPages

        out = np.empty(max(1, n), np.int32)
        got = self._lib.alloc_take(self._h, n, _ptr(out))
        if got < 0:
            raise OutOfPages(f"need {n} pages, {self.num_free} free")
        return out[:n].tolist()

    def free(self, pages) -> None:
        if not len(pages):
            return
        arr = _as_i32(pages)
        self._lib.alloc_release(self._h, _ptr(arr), len(arr))

    def can_alloc(self, n: int) -> bool:
        return n <= self.num_free


class NativeCacheManager:
    """Fully-native CacheManager: ONE ABI crossing per scheduler operation
    (admit / grow / release), the batching the round-1 per-call variant
    lacked. Drop-in for ``runtime.cache_manager.CacheManager``."""

    # The native structures model no host tier (``make_cache_manager``
    # keeps the Python manager when one is attached).
    host_tier = None

    def __init__(self, page_size: int, num_pages: int,
                 enable_prefix_cache: bool = True,
                 max_model_len: int = 32768,
                 linear_state: bool = False,
                 on_slot_free=None):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_model_len = max_model_len
        self.enable_prefix_cache = enable_prefix_cache
        # Hybrid models: matches truncate to snapshot-carrying nodes and
        # release attaches the request's snapshots (the Python
        # CacheManager's semantics).
        self.linear_state = linear_state
        self.on_slot_free = on_slot_free
        self.prefix_cache = NativeRadixPageCache(page_size,
                                                 on_evict_slot=on_slot_free)
        self.allocator = NativePageAllocator(num_pages)
        # rid -> number of tree-shared pages (for release's unlock walk).
        self._shared: dict[str, int] = {}
        # rid -> the retired tree its lock belongs to (requests that held
        # pages when a refit invalidated the prefix cache; see
        # ``invalidate_prefix_cache``).
        self._stale: dict[str, NativeRadixPageCache] = {}
        # Per-adapter prefix-cache namespaces (``ns_salt``).
        self._ns_salts: dict[str, int] = {}
        from parallax_tpu_torch.runtime.cache_manager import CacheStats

        self.stats = CacheStats()

    def _ns_i32(self, token_ids, lora_id) -> np.ndarray:
        """int32 tokens, XOR-salted at numpy speed for adapter requests
        (the scheduler hot path must stay free of per-token Python)."""
        from parallax_tpu_torch.runtime.cache_manager import ns_salt

        tokens = _as_i32(token_ids)
        salt = ns_salt(self._ns_salts, lora_id)
        if salt is not None:
            tokens = tokens ^ np.int32(salt)
        return tokens

    # -- capacity ---------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return self.allocator.num_free

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    # -- request lifecycle ------------------------------------------------

    def allocate_for_prompt(self, request) -> bool:
        if self.linear_state and hasattr(request, "restore_state_from"):
            del request.restore_state_from  # stale from a failed admit
        tokens = self._ns_i32(
            request.prompt_ids, getattr(request, "lora_id", None)
        )
        cap = self.pages_needed(len(tokens)) + 1
        out = np.empty(cap, np.int32)
        shared = ctypes.c_int64(0)
        restore = np.full(1, -1, np.int32)
        head_cached = getattr(request, "mirror_head_cached", None)
        pages_cap = (head_cached // self.page_size
                     if self.linear_state and head_cached is not None
                     else -1)
        total = self._lib.cache_admit(
            self.prefix_cache._h, self.allocator._h,
            _ptr(tokens), len(tokens), int(self.enable_prefix_cache),
            int(self.linear_state), pages_cap, _ptr(out), cap,
            ctypes.byref(shared), _ptr(restore),
        )
        self.prefix_cache._drain_slots()   # the admit may have evicted
        if total < 0:
            return False
        request.page_ids = out[:total].tolist()
        request.num_cached_tokens = int(shared.value) * self.page_size
        request.num_computed_tokens = request.num_cached_tokens
        if int(restore[0]) >= 0:
            request.restore_state_from = int(restore[0])
        self._shared[request.request_id] = int(shared.value)
        self.stats.tokens_admitted += len(tokens)
        self.stats.tokens_hit_device += request.num_cached_tokens
        return True

    def ensure_capacity(self, request, new_total_tokens: int) -> bool:
        need = self.pages_needed(new_total_tokens) - len(request.page_ids)
        if need <= 0:
            return True
        out = np.empty(need, np.int32)
        got = self._lib.cache_grow(
            self.prefix_cache._h, self.allocator._h, need, _ptr(out)
        )
        self.prefix_cache._drain_slots()   # the grow may have evicted
        if got < 0:
            return False
        request.page_ids.extend(out[:need].tolist())
        return True

    def extend_prefix_match(self, request) -> int:
        """Mid-prefill chunk skipping — semantics mirror
        ``CacheManager.extend_prefix_match`` (the behavioral oracle).
        This is a rare per-request event (a donor released after this
        request was admitted), not the admit/grow/release hot path, so
        per-call ABI crossings are fine here. The native tree has no
        host tier, so there is no host-node truncation case."""
        if not self.enable_prefix_cache:
            return 0
        if self.linear_state:
            # A linear-state skip needs the snapshot wired at the skip
            # boundary, which only the admission match sets up.
            return 0
        if getattr(request, "mirror_head_cached", None) is not None:
            # Mirrors may only skip what the head skipped.
            return 0
        num_shared = self._shared.get(request.request_id)
        if num_shared is None or request.request_id in self._stale:
            return 0
        prompt_len = request.num_prompt_tokens
        if prompt_len <= 1:
            return 0
        tokens = self._ns_i32(
            request.prompt_ids, getattr(request, "lora_id", None)
        )
        pages, full_path = self.prefix_cache.match_prefix(tokens)
        usable = min(len(pages), (prompt_len - 1) // self.page_size)
        if usable <= num_shared:
            return 0
        new_shared = pages[:usable]
        if new_shared[:num_shared] != request.page_ids[:num_shared]:
            # The tree's page chain diverged from what this request
            # pinned at admission — refuse rather than corrupt.
            return 0
        # Lock the longer path before unlocking the old one so shared
        # ancestors never drop to zero refs in between. The old locked
        # path is the num_shared-prefix of the same token stream.
        self.prefix_cache.lock(
            self.prefix_cache.slice_path(full_path, usable)
        )
        self.prefix_cache.unlock(
            self.prefix_cache.slice_path(full_path, num_shared)
        )
        self.allocator.free(request.page_ids[num_shared:usable])
        request.page_ids = new_shared + request.page_ids[usable:]
        request.num_cached_tokens = usable * self.page_size
        request.num_computed_tokens = usable * self.page_size
        self._shared[request.request_id] = usable
        skipped = (usable - num_shared) * self.page_size
        self.stats.tokens_hit_device += skipped
        self.stats.tokens_chunk_skipped += skipped
        return skipped

    def release(self, request) -> None:
        n_shared = self._shared.pop(request.request_id, 0)
        snapshots = list(getattr(request, "state_snapshots", {}).values())
        if hasattr(request, "state_snapshots"):
            del request.state_snapshots
        stale = self._stale.pop(request.request_id, None)
        if stale is not None:
            self._release_stale(stale, request, n_shared, snapshots)
            return
        pages = _as_i32(request.page_ids)
        if not len(pages):
            self._free_slots(slot for _, slot in snapshots)
            request.page_ids = []
            return
        tokens = self._ns_i32(
            request.all_token_ids, getattr(request, "lora_id", None)
        )
        computed = min(request.num_computed_tokens, len(tokens))
        insert = int(
            self.enable_prefix_cache
            and request.status.value != "finished_abort"
        )
        if snapshots:
            # Each (length, slot) attaches at its boundary inside the same
            # call; the ones that cannot come back as ``unattached``.
            lens = np.ascontiguousarray([n for n, _ in snapshots],
                                        dtype=np.int64)
            slots = _as_i32([slot for _, slot in snapshots])
            unattached = np.empty(len(snapshots), np.int32)
            n_un = self._lib.cache_release(
                self.prefix_cache._h, self.allocator._h,
                _ptr(tokens), len(tokens), computed,
                _ptr(pages), len(pages), n_shared, insert,
                lens.ctypes.data_as(_I64P), _ptr(slots), len(snapshots),
                _ptr(unattached),
            )
            self._free_slots(int(s) for s in unattached[:n_un].tolist())
        else:
            # No snapshots to attach: zero extra allocations.
            self._lib.cache_release(
                self.prefix_cache._h, self.allocator._h,
                _ptr(tokens), len(tokens), computed,
                _ptr(pages), len(pages), n_shared, insert,
                None, None, 0, None,
            )
        request.page_ids = []

    def _release_stale(self, tree, request, n_shared: int,
                       snapshots) -> None:
        """Release a request admitted before a refit: unlock its path in
        the retired ``tree`` and free its own pages (nothing is donated:
        its KV is the old weights'), then drop the retired tree's nodes no
        other request holds."""
        self._free_slots(slot for _, slot in snapshots)
        pages = _as_i32(request.page_ids)
        if len(pages):
            tokens = self._ns_i32(
                request.all_token_ids, getattr(request, "lora_id", None)
            )
            self._lib.cache_release(
                tree._h, self.allocator._h, _ptr(tokens), len(tokens),
                min(request.num_computed_tokens, len(tokens)),
                _ptr(pages), len(pages), n_shared, 0, None, None, 0, None,
            )
        self.allocator.free(tree.evict(tree.num_cached_pages))
        request.page_ids = []

    def _free_slots(self, slots) -> None:
        for slot in slots:
            if self.on_slot_free:
                self.on_slot_free(slot)

    def reset_prefix_cache(self) -> None:
        self.allocator.free(self.prefix_cache.reset())

    def invalidate_prefix_cache(self) -> int:
        """The Python manager's ``invalidate_prefix_cache``: a fresh tree
        replaces the old one (every adapter namespace with it), whose
        unlocked nodes (and their snapshot slots) go now and whose locked
        paths go as the requests holding them release. Returns the pages
        the old tree held."""
        old = self.prefix_cache
        n = old.num_cached_pages
        self.prefix_cache = NativeRadixPageCache(
            self.page_size, on_evict_slot=self.on_slot_free)
        for rid in self._shared:
            self._stale.setdefault(rid, old)
        self.allocator.free(old.evict(n))
        self.stats.pages_invalidated += n
        return n


def native_available() -> bool:
    return load_library() is not None
