"""Per-request LoRA adapters for multi-tenant serving (port of
``parallax_tpu/ops/lora.py``).

Adapters are never merged into the base weights at serving time. Every
registered adapter's ``A`` / ``B`` matrices are stacked into fixed-shape
f32 tensors ``[num_slots, ...]`` on the serving device (ranks zero-padded
to the set's largest, the union of every adapter's sites), the local
scheduler groups each dispatched batch by adapter, and the batch's slot
rides into the step as a DEVICE tensor; a decode-only batch of several
tenants carries one slot a token row instead (the mixed form). The delta
(``models/layers.py::_lora_delta``) is two thin products per projection,
``(x @ A^T) @ B^T * scale``, the adapter picked by comparing the slot(s)
with the adapter index: both forms run the one contraction, so a row's
delta has the same bits in a grouped batch and in a mixed one. So one step
function, and one captured CUDA graph per shape, serves every adapter: a
graph reads the slot from its static state, never from a Python value
frozen into it.

Every (re)stack makes new tensors and bumps :attr:`AdapterSet.generation`;
the engine keys its window graphs on it, so a graph of an older stack is
dropped and never replays freed memory.

``B`` is stored as the transposed view of a contiguous ``[n, r, out]``
tensor: it reads as the JAX package's ``[n, out, r]`` while the mixed
form's joint ``(n, r)`` contraction takes ``[n * r, out]`` as a view.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from parallax_tpu_torch.obs import names as mnames
from parallax_tpu_torch.utils import get_logger, unported
from parallax_tpu_torch.utils.hw import resolve_device

logger = get_logger(__name__)

# Projections a per-request adapter may target, as ``group.proj`` paths
# inside one decoder layer's param dict.
SUPPORTED_PROJS = (
    "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
    "self_attn.o_proj",
    "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj",
)

_LAYER_RE = re.compile(r"(?:^|\.)layers\.(\d+)\.(.+)$")


def _f32(x) -> torch.Tensor:
    """A host f32 tensor of ``x`` (numpy array or tensor), always a copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.tensor(np.asarray(x, np.float32))


def adapter_tree_from_peft(
    adapter_path: str, start_layer: int, end_layer: int
) -> dict:
    """Load a PEFT adapter directory into this stage's adapter tree:
    ``{local_layer_idx: {"group.proj": (A f32[r, in], B f32[out, r],
    scale)}}`` (host tensors).

    Modules outside ``[start_layer, end_layer)`` are ignored (they belong
    to other pipeline stages); unsupported target modules raise."""
    from parallax_tpu_torch.utils.adapter import _load_adapter

    pairs, scales = _load_adapter(adapter_path)
    tree: dict[int, dict[str, tuple]] = {}
    for mod, ab in pairs.items():
        m = _LAYER_RE.search(mod)
        if m is None:
            raise ValueError(
                f"unsupported adapter target {mod!r} (per-request adapters "
                "cover decoder-layer projections only)"
            )
        gi, path = int(m.group(1)), m.group(2)
        if path not in SUPPORTED_PROJS:
            raise ValueError(f"unsupported adapter target {mod!r}")
        if not (start_layer <= gi < end_layer):
            continue
        if "M" in ab:
            raise ValueError(
                "DoRA adapters cannot be applied per-request; merge "
                "offline with `cli lora-merge`"
            )
        tree.setdefault(gi - start_layer, {})[path] = (
            _f32(ab["A"]), _f32(ab["B"]), float(scales[mod]),
        )
    if not tree:
        # Legitimate for a mid-pipeline stage when the adapter targets
        # only other stages' layers; its delta is a no-op here.
        logger.warning(
            "adapter at %s has no modules in layers [%d, %d)",
            adapter_path, start_layer, end_layer,
        )
    return tree


def adapter_tree_from_numpy(tree: dict) -> dict:
    """An adapter tree of numpy arrays (the JAX package's form) as host
    f32 tensors, keys and scales unchanged."""
    return {
        li: {path: (_f32(a), _f32(b), float(s))
             for path, (a, b, s) in layer.items()}
        for li, layer in tree.items()
    }


def intersect_adapter_names(name_lists) -> list[str]:
    """Adapters EVERY participant can serve (frontend advertising): a
    name missing on one stage / node would fail mid-pipeline after being
    listed. Empty input -> nothing advertised."""
    it = iter(name_lists)
    try:
        names = set(next(it))
    except StopIteration:
        return []
    for other in it:
        names &= set(other)
    return sorted(names)


def parse_adapter_spec(spec: str | None) -> dict[str, str]:
    """CLI ``name=peft_dir[,name=dir]`` -> {name: dir}."""
    out: dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad --lora-adapters entry {part!r} (want name=path)"
            )
        name, path = part.split("=", 1)
        out[name.strip()] = path.strip()
    return out


class AdapterSet:
    """Registered adapters of one stage, stacked for in-step selection on
    ``device`` (None = ``cuda:0``; the CPU only when asked for).

    Registration is rare (admin plane); every (re)build stacks all
    adapters into ``[num_slots, ...]`` tensors and bumps
    :attr:`generation`.

    **Hot-load / evict LRU**: with ``max_adapters > 0`` the set is a
    managed cache — registering past the cap evicts the least-recently
    USED adapter (use = appearing in a dispatched batch), never one the
    caller marks ``active`` (in-flight requests must keep their weights).
    The adapter's prefix-cache namespace (``cache_manager.derive_ns_salt``)
    is deterministic, so a re-load later re-joins it. 0 (the default) =
    unbounded.
    """

    def __init__(self, max_adapters: int = 0, device=None):
        self.max_adapters = max_adapters
        self.device = resolve_device(device)
        self._adapters: "OrderedDict[str, dict]" = OrderedDict()
        self._stacked = None
        # Bumped by every stack: graphs captured over an older stack's
        # tensors must not replay.
        self.generation = 0
        self.evicted_total = 0
        # LRU recency lives OUTSIDE the adapter dict: ``slot_of`` and
        # ``_stack`` key off the dict's insertion order, so a use-time
        # reorder would desync a batch's slot from the stacked tensors.
        self._use_clock = 0
        self._last_used: dict[str, int] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._adapters

    @property
    def names(self) -> list[str]:
        return list(self._adapters)

    def touch(self, name: str | None) -> None:
        """LRU bump on batch use (one counter write; never reorders the
        slot-defining dict)."""
        if name is not None and name in self._adapters:
            self._use_clock += 1
            self._last_used[name] = self._use_clock

    def register(self, name: str, tree: dict, active=()) -> list[str]:
        """``tree``: {local_layer: {"group.proj": (A, B, scale)}} (numpy
        arrays or tensors). Returns the names evicted to stay under
        ``max_adapters`` (never ``name`` itself and never a member of
        ``active``)."""
        for layer_tree in tree.values():
            for path in layer_tree:
                if path not in SUPPORTED_PROJS:
                    raise ValueError(f"unsupported adapter path {path!r}")
        self._adapters[name] = adapter_tree_from_numpy(tree)
        self.touch(name)
        evicted: list[str] = []
        if self.max_adapters > 0:
            keep = set(active) | {name}
            victims = sorted(
                (n for n in self._adapters if n not in keep),
                key=lambda n: self._last_used.get(n, 0),
            )
            while len(self._adapters) > self.max_adapters and victims:
                cand = victims.pop(0)
                del self._adapters[cand]
                self._last_used.pop(cand, None)
                evicted.append(cand)
                self.evicted_total += 1
        self._stacked = None
        if evicted:
            logger.info(
                "LoRA LRU evicted %s (cap %d); slots rebuild on next "
                "adapter batch", evicted, self.max_adapters,
            )
            try:
                from parallax_tpu_torch.obs.registry import get_registry

                get_registry().counter(
                    mnames.LORA_ADAPTER_EVICTIONS_TOTAL,
                    "Adapters evicted by the hot-load LRU cache",
                ).inc(len(evicted))
            except Exception:  # pragma: no cover - metrics never break
                pass
        logger.info("registered LoRA adapter %r (%d total)", name,
                    len(self._adapters))
        return evicted

    def slot_of(self, name: str) -> int:
        return list(self._adapters).index(name)

    def stacked(self) -> dict:
        """The stacked tensors ``{str(layer): {path: {"A", "B", "s"}}}``,
        built on first use after a change."""
        if self._stacked is None:
            self._stacked = self._stack()
            self.generation += 1
        return self._stacked

    def batch_field(self, name: str, slot: torch.Tensor | None = None
                    ) -> dict:
        """The ``BatchInputs.lora`` value for a batch using ``name``:
        ``{"slot": i64[1], "layers": stacked}``. ``slot`` is a device
        tensor already holding :meth:`slot_of` (the engine stages it);
        None builds one here."""
        self.touch(name)
        layers = self.stacked()
        if slot is None:
            slot = torch.tensor([self.slot_of(name)], dtype=torch.int64,
                                device=self.device)
        return {"slot": slot, "layers": layers}

    def mixed_batch_field(self, token_slots) -> dict:
        """The ``BatchInputs.lora`` value for a MIXED-adapter batch:
        ``{"slots": i32[T], "layers": stacked}`` — every row selects its
        own adapter (base rows hold the null slot ``num_adapters``, which
        matches no adapter, so their delta vanishes)."""
        layers = self.stacked()
        if not isinstance(token_slots, torch.Tensor):
            token_slots = torch.as_tensor(np.asarray(token_slots, np.int32),
                                          device=self.device)
        return {"slots": token_slots, "layers": layers}

    def token_slot(self, name: str | None) -> int:
        """Row slot for mixed batches; base rows (None) get the null slot
        one past the last adapter."""
        self.touch(name)
        return self.slot_of(name) if name is not None else len(self._adapters)

    def _stack(self) -> dict:
        n = len(self._adapters)
        # Union of (layer, path) across adapters; missing entries are
        # zero-filled so their delta vanishes.
        sites: dict[tuple[int, str], tuple[int, int, int]] = {}
        for tree in self._adapters.values():
            for li, layer_tree in tree.items():
                for path, (a, b, _s) in layer_tree.items():
                    r, in_dim = a.shape
                    out_dim = b.shape[0]
                    prev = sites.get((li, path))
                    if prev is not None:
                        if (prev[1], prev[2]) != (in_dim, out_dim):
                            raise ValueError(
                                f"adapter shape mismatch at layer {li} "
                                f"{path}: {prev[1:]} vs "
                                f"{(in_dim, out_dim)}"
                            )
                        r = max(r, prev[0])
                    sites[(li, path)] = (r, in_dim, out_dim)

        stacked: dict[str, dict[str, dict]] = {}
        for (li, path), (r, in_dim, out_dim) in sites.items():
            a_stack = torch.zeros((n, r, in_dim), dtype=torch.float32)
            bt_stack = torch.zeros((n, r, out_dim), dtype=torch.float32)
            s_stack = torch.zeros((n,), dtype=torch.float32)
            for slot, tree in enumerate(self._adapters.values()):
                ent = tree.get(li, {}).get(path)
                if ent is None:
                    continue
                a, b, s = ent
                a_stack[slot, : a.shape[0]] = a
                bt_stack[slot, : b.shape[1]] = b.t()
                s_stack[slot] = s
            stacked.setdefault(str(li), {})[path] = {
                "A": a_stack.to(self.device),
                "B": bt_stack.to(self.device).transpose(1, 2),
                "s": s_stack.to(self.device),
            }
        return stacked


# Projection classes under tensor parallelism: column-sharded projections
# slice the delta's B on its out dim, row-sharded ones slice A on its in
# dim.
_COL_PROJS = frozenset({"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"})
_ROW_PROJS = frozenset({"o_proj", "down_proj"})


def select_slot(lora: dict, axis_name: str | None = None, tp: int = 1):
    """Thread the batch's slot tensor into every site: ``slot`` (i64[1],
    one adapter a batch) or ``slots`` (i32[T], one a token row). The
    selection happens in ``layers._lora_delta`` by comparing the DEVICE
    slot(s) with the adapter index, so a captured graph reads the slot of
    each replay, and a row's delta is the same computation whether its
    batch holds one adapter or several.

    The JAX package's tensor-parallel branch (``axis_name`` with ``tp >
    1``: each shard slices its partition of A or B) waits for tensor
    parallelism."""
    if axis_name is not None and tp > 1:
        raise unported("tensor-parallel LoRA (select_slot axis_name)", 10)
    key = "slots" if "slots" in lora else "slot"
    return {
        li: {path: dict(ab, **{key: lora[key]}) for path, ab in layer.items()}
        for li, layer in lora["layers"].items()
    }


def validate_tp_shardable(tree: dict, tp: int) -> None:
    """Reject adapters whose targeted projections cannot shard ``tp``
    ways (indivisible out dim on a column projection / in dim on a row
    projection) — at registration, not mid-forward."""
    if tp <= 1:
        return
    for li, layer_tree in tree.items():
        for path, (a, b, _s) in layer_tree.items():
            proj = path.rsplit(".", 1)[-1]
            if proj in _COL_PROJS and b.shape[0] % tp:
                raise ValueError(
                    f"adapter layer {li} {path}: out dim {b.shape[0]} "
                    f"not divisible by tp={tp}"
                )
            if proj in _ROW_PROJS and a.shape[1] % tp:
                raise ValueError(
                    f"adapter layer {li} {path}: in dim {a.shape[1]} "
                    f"not divisible by tp={tp}"
                )


def merge_layer_lora(lp: dict, layer_sel: dict | None) -> dict:
    """Shallow-copy a layer's param dict with ``{"lora": {A, B, s}}``
    attached to each adapted projection (consumed by ``layers.linear``).
    Paths absent from this layer's params are skipped (a block with
    another structure simply never sees the delta)."""
    if not layer_sel:
        return lp
    lp = dict(lp)
    for path, ab in layer_sel.items():
        grp, proj = path.split(".")
        if grp not in lp or proj not in lp[grp]:
            continue
        lp[grp] = dict(lp[grp])
        lp[grp][proj] = dict(lp[grp][proj])
        lp[grp][proj]["lora"] = ab
    return lp
