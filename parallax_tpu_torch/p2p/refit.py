"""Weight refit: replace a serving stage's weights in place (port of
``parallax_tpu/p2p/refit.py``; RL weight pushes).

``POST /weight/refit`` registers ``{version, index_map}`` with the global
scheduler; heartbeat replies carry the index to every worker; each worker
fetches only its layer range off the step thread, checks the sha256, and
the step thread swaps the weights; routers skip pipelines whose
``refit_version`` lags. An index entry is ``{"uri": file-or-http
safetensors, "sha256": hex?}`` (or a bare uri): content addressing with an
explicit transport, fetched per node.

Where the port differs from the JAX module:

- Bytes decode with the port's own reader (``models/loader.py::
  SafetensorsFile.from_bytes``) and writer (``utils/st_writer.py``): the
  card has no ``safetensors`` package.
- The fetch makes CPU tensors only; the host-to-device copy happens in the
  apply, on the step thread (the only thread that makes CUDA calls).
- The apply copies each tensor INTO the existing storage (``copy_``, a
  stacked-expert row through ``old[e].copy_``), casting as ``astype``
  does, where the JAX apply rebinds leaves of the tree. The engine's
  window graphs read the weights at the addresses they were captured
  with: a rebound leaf would leave every graph replaying the old weights.
  In place, every graph stays valid and no HBM is added beyond one tensor
  in flight. Under a CUDA graph capture the apply refuses.
- After the swap the engine invalidates its prefix cache
  (``StageEngine.on_weights_replaced``): the JAX refit leaves it, so a
  request after the refit reuses KV computed under the old weights.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import torch

from parallax_tpu_torch.models.loader import SafetensorsFile, shard_key_filter
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)

_READ_CHUNK = 64 << 20


def fetch_uri(uri: str, timeout_s: float = 120.0) -> bytearray:
    """The bytes at ``uri`` (``file://``, ``http(s)://`` or a bare path),
    as a writable buffer the decoder reads in place."""
    if uri.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(uri, timeout=timeout_s) as resp:
            return bytearray(resp.read())
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view, got = memoryview(buf), 0
        while got < len(buf):
            n = f.readinto(view[got:])
            if not n:
                raise OSError(f"{path}: short read ({got} of {len(buf)})")
            got += n
    return buf


def verify_checksum(data, expected_sha256: str | None) -> None:
    if not expected_sha256:
        return
    got = hashlib.sha256(data).hexdigest()
    if got != expected_sha256:
        raise ValueError(f"refit checksum mismatch: {got} != {expected_sha256}")


def load_refit_tensors(
    index_map: dict,
    start_layer: int,
    end_layer: int,
    num_layers: int,
    want_embed: bool,
    fetch=fetch_uri,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Fetch and decode the tensors this stage needs, as CPU tensors.

    ``index_map``: weight name -> uri string or {"uri": ..., "sha256":
    ...}. Entries may point at per-tensor safetensors blobs or shared
    files (fetched once, cached by uri). ``stats``, when given, gains the
    seconds spent fetching (``fetch_s``), hashing (``sha256_s``) and
    decoding (``decode_s``) and the bytes fetched."""
    blobs: dict[str, SafetensorsFile] = {}
    out: dict[str, torch.Tensor] = {}
    acc = {"fetch_s": 0.0, "sha256_s": 0.0, "decode_s": 0.0, "bytes": 0}
    for name, entry in index_map.items():
        local = shard_key_filter(name, start_layer, end_layer, num_layers)
        if local is None:
            continue
        if local.startswith("embed_tokens") and not want_embed:
            continue
        uri = entry["uri"] if isinstance(entry, dict) else entry
        sha = entry.get("sha256") if isinstance(entry, dict) else None
        if uri not in blobs:
            t0 = time.perf_counter()
            data = fetch(uri)
            t1 = time.perf_counter()
            verify_checksum(data, sha)
            t2 = time.perf_counter()
            blobs[uri] = SafetensorsFile.from_bytes(
                data if isinstance(data, bytearray) else bytes(data), uri)
            acc["fetch_s"] += t1 - t0
            acc["sha256_s"] += t2 - t1
            acc["decode_s"] += time.perf_counter() - t2
            acc["bytes"] += len(data)
        blob = blobs[uri]
        if name not in blob.keys():
            raise KeyError(f"{name} missing from {uri}")
        t0 = time.perf_counter()
        out[local] = blob.get_tensor(name)
        acc["decode_s"] += time.perf_counter() - t0
    if stats is not None:
        for k, v in acc.items():
            stats[k] = stats.get(k, 0) + v
    return out


def _locate(params: dict, local_path: str):
    """Resolve a local weight path to (container, key, expert_index).

    Handles per-expert checkpoint paths (``layers.N.mlp.experts.3.
    gate_proj.weight``) landing in the *stacked* expert tensors that
    ``finalize_params`` produced at load time: the new tensor replaces one
    row of the stacked tensor."""
    parts = local_path.split(".")
    node = params
    i = 0
    while i < len(parts) - 1:
        part = parts[i]
        child = node[int(part)] if isinstance(node, list) else node.get(part)
        if (
            part == "experts"
            and isinstance(child, dict)
            and i + 1 < len(parts)
            and parts[i + 1].isdigit()
            and parts[i + 1] not in child
        ):
            # Stacked experts: parts = [..., "experts", idx, proj, "weight"].
            expert_idx = int(parts[i + 1])
            proj = parts[i + 2]
            return child, proj, expert_idx
        node = child
        i += 1
    return node, parts[-1], None


def fetch_refit_tensors(engine, index_map: dict, fetch=fetch_uri,
                        stats: dict | None = None) -> dict:
    """Download and verify this stage's tensors (no engine mutation and no
    CUDA call: safe off the step thread, so decoding never stalls on
    network IO)."""
    model = engine.model
    cfg = model.config
    want_embed = model.is_first or (model.is_last and cfg.tie_word_embeddings)
    return load_refit_tensors(
        index_map, model.start_layer, model.end_layer,
        cfg.num_hidden_layers, want_embed, fetch, stats,
    )


def apply_refit(engine, index_map: dict, version: int, fetch=fetch_uri) -> int:
    """Fetch and swap in one call (tests, synchronous callers)."""
    tensors = fetch_refit_tensors(engine, index_map, fetch)
    return apply_prefetched(engine, tensors, version)


def apply_prefetched(engine, tensors: dict, version: int) -> int:
    """Swap pre-fetched tensors into the engine's weights in place, on
    the thread that steps the engine. Returns the tensors replaced.

    Two phases for atomicity: every tensor is located, shape-checked and
    dtype-checked first; only then is any weight written, so a bad entry
    leaves the serving weights untouched instead of half-updated. A
    quantized leaf (``qweight`` / ``scales``) has no ``weight`` to write:
    it raises in the first phase, as the JAX apply does."""
    model = engine.model
    if not tensors:
        return 0
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("refit refused: a CUDA graph capture is in "
                           "progress on this stream")
    staged = []
    for local_path, arr in tensors.items():
        container, key, expert_idx = _locate(engine.params, local_path)
        old = container.get(key) if isinstance(container, dict) else None
        if not isinstance(old, torch.Tensor):
            raise KeyError(f"refit: no float weight at {local_path} (a "
                           f"quantized leaf or a path the tree lacks)")
        dst = old[expert_idx] if expert_idx is not None else old
        if tuple(dst.shape) != tuple(arr.shape):
            raise ValueError(
                f"refit shape mismatch for {local_path}: "
                f"{tuple(dst.shape)} vs {tuple(arr.shape)}"
            )
        if dst.is_floating_point() != arr.is_floating_point():
            raise ValueError(
                f"refit dtype mismatch for {local_path}: {dst.dtype} vs "
                f"{arr.dtype}"
            )
        staged.append((dst, arr))
    with torch.no_grad():
        for dst, arr in staged:
            # In place, cast as astype(old.dtype) (round to nearest even).
            dst.copy_(arr)
    invalidated = engine.on_weights_replaced()
    logger.info(
        "refit v%d applied in place: %d tensors for layers [%d, %d), %d "
        "prefix-cache pages invalidated", version, len(tensors),
        model.start_layer, model.end_layer, invalidated,
    )
    return len(tensors)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_READ_CHUNK)
            if not chunk:
                return h.hexdigest()
            h.update(chunk)


def build_index_map(
    safetensors_path: str, base_uri: str | None = None
) -> dict:
    """Helper for refit initiators: index every tensor of a safetensors
    file with the file's checksum."""
    uri = base_uri or f"file://{os.path.abspath(safetensors_path)}"
    sha = _sha256_file(safetensors_path)
    return {name: {"uri": uri, "sha256": sha}
            for name in SafetensorsFile(safetensors_path).keys()}


class RefitVersionStore:
    """On-disk cache of fetched refit versions with bounded history: a
    restarting worker reloads the newest pushed weights without
    refetching, and the directory keeps only the newest ``keep``
    versions. The layout is the JAX store's (``v%08d.safetensors`` with a
    ``v%08d.json`` of the model and layer range)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _path(self, version: int) -> str:
        return os.path.join(self.root, f"v{version:08d}.safetensors")

    def _meta_path(self, version: int) -> str:
        return os.path.join(self.root, f"v{version:08d}.json")

    def versions(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("v") and name.endswith(".safetensors"):
                try:
                    out.append(int(name[1:-len(".safetensors")]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, version: int, tensors: dict,
             meta: dict | None = None) -> str:
        """Persist one version's stage tensors atomically (temp file and
        rename, so a crash mid-write never leaves a truncated newest
        version), then drop old versions. ``meta`` records which (model,
        layer range) the stage-local keys belong to; a restore checks
        it."""
        from parallax_tpu_torch.utils.st_writer import write_safetensors

        path = self._path(version)
        tmp = path + ".tmp"
        write_safetensors(tmp, tensors)
        os.replace(tmp, path)
        if meta is not None:
            mtmp = self._meta_path(version) + ".tmp"
            with open(mtmp, "w", encoding="utf-8") as f:
                json.dump(meta, f)
            os.replace(mtmp, self._meta_path(version))
        self.gc()
        return path

    def load(self, version: int) -> dict[str, torch.Tensor]:
        """One version's tensors, as CPU tensors."""
        f = SafetensorsFile(self._path(version))
        return {k: f.get_tensor(k) for k in f.keys()}

    def load_meta(self, version: int) -> dict | None:
        try:
            with open(self._meta_path(version), encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def gc(self) -> list[int]:
        """Drop everything but the newest ``keep`` versions."""
        versions = self.versions()
        removed = []
        for v in versions[:-self.keep] if self.keep else versions:
            try:
                os.remove(self._path(v))
                if os.path.exists(self._meta_path(v)):
                    os.remove(self._meta_path(v))
                removed.append(v)
            except OSError:
                logger.exception("refit GC failed for v%d", v)
        if removed:
            logger.info("refit GC removed versions %s", removed)
        return removed
