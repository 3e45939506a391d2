"""Phase-1 scheduling: assign contiguous layer ranges to nodes (port of
``parallax_tpu/scheduling/layer_allocation.py``, verbatim).

Capability parity: reference ``src/scheduling/layer_allocation.py:70-1015``
— water-filling rebalance (solve lambda s.t. sum(min(cap_i,
lambda*speed_i)) = L), a greedy allocator packing standby nodes into as
many full pipelines as possible, an exact DP allocator maximizing pipeline
count, dynamic join, and the coefficient-of-variation global-rebalance
trigger.
"""

from __future__ import annotations

import math
import statistics

from parallax_tpu_torch.scheduling.node import Node
from parallax_tpu_torch.scheduling.node_management import Pipeline
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def water_fill_layers(nodes: list[Node], num_layers: int) -> list[int] | None:
    """Split ``num_layers`` across ``nodes`` proportional to speed, capped by
    each node's memory capacity.

    Solves sum_i min(cap_i, lambda * speed_i) = L by bisection on lambda,
    then rounds to integers preserving the total (reference
    ``adjust_pipeline_layers``, layer_allocation.py:278-400).
    Returns per-node layer counts (every node >= 1), or None if the group
    cannot host the model.
    """
    caps = [n.layer_capacity() for n in nodes]
    if sum(caps) < num_layers or len(nodes) > num_layers:
        return None
    speeds = [1.0 / max(1e-9, n.layer_latency_ms()) for n in nodes]

    lo, hi = 0.0, num_layers / max(min(speeds), 1e-9) + 1.0
    for _ in range(64):
        mid = (lo + hi) / 2
        total = sum(min(c, mid * s) for c, s in zip(caps, speeds))
        if total < num_layers:
            lo = mid
        else:
            hi = mid
    raw = [min(c, hi * s) for c, s in zip(caps, speeds)]

    # Integer rounding: floor, then hand out the remainder by largest
    # fractional part, respecting caps and a floor of 1 layer per node.
    counts = [max(1, min(cap, math.floor(r))) for r, cap in zip(raw, caps)]
    rem = num_layers - sum(counts)
    if rem < 0:
        # Floors of 1 overshot; trim from the slowest nodes.
        order = sorted(range(len(nodes)), key=lambda i: speeds[i])
        for i in order:
            take = min(counts[i] - 1, -rem)
            counts[i] -= take
            rem += take
            if rem == 0:
                break
        if rem != 0:
            return None
    else:
        frac_order = sorted(
            range(len(nodes)), key=lambda i: raw[i] - counts[i], reverse=True
        )
        idx = 0
        while rem > 0 and idx < 4 * len(nodes):
            i = frac_order[idx % len(nodes)]
            if counts[i] < caps[i]:
                counts[i] += 1
                rem -= 1
            idx += 1
        if rem > 0:
            return None
    return counts


def assign_ranges(nodes: list[Node], counts: list[int]) -> None:
    start = 0
    for node, c in zip(nodes, counts):
        node.set_layers(start, start + c)
        start += c


class BaseLayerAllocator:
    def __init__(self, num_layers: int):
        self.num_layers = num_layers

    def allocate(self, standby: list[Node]) -> list[Pipeline]:
        raise NotImplementedError

    def allocate_role_aware(self, standby: list[Node]) -> list[Pipeline]:
        """Allocate within each phase pool separately so pipelines stay
        role-homogeneous (docs/disaggregation.md): a pipeline mixing a
        prefill specialist with a decode specialist could satisfy
        neither phase's routing restriction. Mixed nodes allocate first
        — they carry bootstrap (a swarm of only specialists that cannot
        each complete a pipeline stays unbootstrapped, loudly). Roles
        partition capacity: a prefill node's layers never complete a
        decode pipeline."""
        groups: dict[str, list[Node]] = {}
        for n in standby:
            groups.setdefault(getattr(n, "role", "mixed"), []).append(n)
        out: list[Pipeline] = []
        for role in ("mixed", "prefill", "decode"):
            nodes = groups.pop(role, None)
            if nodes:
                out.extend(self.allocate(nodes))
        # Unknown roles (future builds): allocate them among themselves
        # rather than silently dropping the nodes.
        for nodes in groups.values():
            out.extend(self.allocate(nodes))
        return out

    # -- shared machinery -------------------------------------------------

    def _build_pipeline(self, group: list[Node]) -> Pipeline | None:
        # Faster nodes earlier in the chain slightly reduces TTFT (embedding
        # + early layers see every chunk first).
        group = sorted(group, key=lambda n: n.layer_latency_ms())
        counts = water_fill_layers(group, self.num_layers)
        if counts is None:
            return None
        counts = trim_pipeline_boundaries(group, counts)
        assign_ranges(group, counts)
        return Pipeline(nodes=group)

    def should_global_rebalance(
        self, active: list[Node], cv_threshold: float = 0.5
    ) -> bool:
        """Coefficient of variation of per-layer hosting power (reference
        layer_allocation.py:226-276)."""
        if not active:
            return False
        power = layer_hosting_power(active, self.num_layers)
        if any(p == 0.0 for p in power):
            return True  # uncovered layer: must rebalance
        mean = statistics.fmean(power)
        if mean == 0:
            return True
        cv = statistics.pstdev(power) / mean
        return cv > cv_threshold


class GreedyLayerAllocator(BaseLayerAllocator):
    """Pack standby nodes into full pipelines, largest-capacity first, with
    smallest-fit tail selection (reference layer_allocation.py:582-755)."""

    def allocate(self, standby: list[Node]) -> list[Pipeline]:
        pool = sorted(standby, key=lambda n: n.layer_capacity(), reverse=True)
        pipelines: list[Pipeline] = []
        while pool:
            group: list[Node] = []
            cap = 0
            for n in list(pool):
                if cap >= self.num_layers:
                    break
                group.append(n)
                cap += n.layer_capacity()
            if cap < self.num_layers:
                break
            # Smallest-fit tail: shrink the last slot to the smallest node
            # that still completes the pipeline, keeping big nodes free.
            deficit = self.num_layers - (cap - group[-1].layer_capacity())
            best_tail = None
            for n in pool:
                if n in group[:-1]:
                    continue
                if n.layer_capacity() >= deficit:
                    if (
                        best_tail is None
                        or n.layer_capacity() < best_tail.layer_capacity()
                    ):
                        best_tail = n
            if best_tail is not None:
                group[-1] = best_tail
            pipe = self._build_pipeline(group)
            if pipe is None:
                break
            pipelines.append(pipe)
            for n in pipe.nodes:
                pool.remove(n)
        return pipelines


class DPLayerAllocator(BaseLayerAllocator):
    """Exact DP over the pipeline-count objective.

    For each feasible pipeline count ``k`` compute ``s*(k)``, the minimum
    total number of stages realizing ``k`` full pipelines (DP state:
    node index, sorted residuals of the open pipelines, pipelines
    closed — the interleaved construction is what lets capacities like
    (40, 40, 20, 20, 10, 10) over 70 layers close (40, 20, 10) twice
    instead of one (40, 30) pipeline), then score

        Z(k) = k**alpha / (compute_ms + (s*(k) / k) * hop_ms)

    — throughput grows with k, per-request latency with stages per
    pipeline — and keep the best k. Same objective family as the
    reference DP (``layer_allocation.py:758-1015``), re-derived.
    """

    # The open-residuals DP state is exponential in node heterogeneity;
    # past this pool size fall back to greedy (which is O(n log n) and
    # what the reference does implicitly via its pruning cutoffs).
    MAX_DP_NODES = 12

    def __init__(self, num_layers: int, alpha: float = 2.0,
                 hop_ms: float = 30.0):
        super().__init__(num_layers)
        self.alpha = alpha
        self.hop_ms = hop_ms

    def _min_stages(self, caps: list[int], k: int):
        """(s*(k), plan) or (None, None); plan = list of (node_idx,
        pipeline_slot) in assignment order."""
        from functools import lru_cache

        n = len(caps)
        L = self.num_layers
        suffix = [0] * (n + 1)
        for i in range(n - 1, -1, -1):
            suffix[i] = suffix[i + 1] + caps[i]
        INF = float("inf")

        @lru_cache(maxsize=None)
        def dp(i: int, open_res: tuple, closed: int):
            if closed == k and not open_res:
                return 0
            if i == n:
                return INF
            # Prune: remaining capacity cannot cover what is still open
            # plus the pipelines not yet started.
            need = sum(open_res) + (k - closed - len(open_res)) * L
            if suffix[i] < need:
                return INF
            best = dp(i + 1, open_res, closed)            # skip node i
            for j, r in enumerate(set(open_res)):         # extend open j
                r2 = r - caps[i]
                rest = list(open_res)
                rest.remove(r)
                if r2 <= 0:
                    cand = dp(i + 1, tuple(sorted(rest)), closed + 1)
                else:
                    cand = dp(i + 1, tuple(sorted(rest + [r2])), closed)
                if 1 + cand < best:
                    best = 1 + cand
            if closed + len(open_res) < k:                # open new
                r = L - caps[i]
                if r <= 0:
                    cand = dp(i + 1, open_res, closed + 1)
                else:
                    cand = dp(i + 1, tuple(sorted(open_res + (r,))),
                              closed)
                if 1 + cand < best:
                    best = 1 + cand
            return best

        total = dp(0, (), 0)
        if total == INF:
            dp.cache_clear()
            return None, None

        # Greedy backtrack against the memo: replay the same transitions,
        # taking any choice whose cost matches the optimum.
        plan: list[tuple[int, int]] = []   # (node idx, open-slot id)
        open_res: list[int] = []           # residual per open slot id
        slot_ids: list[int] = []           # stable slot id per open entry
        next_slot = 0
        i, closed = 0, 0
        remaining = total
        while not (closed == k and not open_res):
            key = tuple(sorted(open_res))
            if dp(i + 1, key, closed) == remaining:
                i += 1
                continue
            advanced = False
            for j in range(len(open_res)):
                r2 = open_res[j] - caps[i]
                rest = open_res[:j] + open_res[j + 1:]
                if r2 <= 0:
                    cand = dp(i + 1, tuple(sorted(rest)), closed + 1)
                else:
                    cand = dp(i + 1, tuple(sorted(rest + [r2])), closed)
                if 1 + cand == remaining:
                    plan.append((i, slot_ids[j]))
                    if r2 <= 0:
                        del open_res[j], slot_ids[j]
                        closed += 1
                    else:
                        open_res[j] = r2
                    i += 1
                    remaining -= 1
                    advanced = True
                    break
            if advanced:
                continue
            r = self.num_layers - caps[i]
            plan.append((i, next_slot))
            if r <= 0:
                closed += 1
            else:
                open_res.append(r)
                slot_ids.append(next_slot)
            next_slot += 1
            i += 1
            remaining -= 1
        dp.cache_clear()
        return total, plan

    def allocate(self, standby: list[Node]) -> list[Pipeline]:
        if len(standby) > self.MAX_DP_NODES:
            return GreedyLayerAllocator(self.num_layers).allocate(standby)
        nodes = sorted(standby, key=lambda n: n.layer_capacity(),
                       reverse=True)
        L = self.num_layers
        caps = [min(x.layer_capacity(), L) for x in nodes]
        total_cap = sum(caps)
        if not nodes or total_cap < L:
            return []
        mean_layer_ms = sum(
            n.layer_latency_ms() for n in nodes
        ) / len(nodes)
        compute_ms = max(L * mean_layer_ms, 1e-6)

        best_score, best_plan, best_k = float("-inf"), None, 0
        for k in range(1, min(len(nodes), total_cap // L) + 1):
            s_star, plan = self._min_stages(caps, k)
            if s_star is None:
                continue
            score = k ** self.alpha / (
                compute_ms + (s_star / k) * self.hop_ms
            )
            if score > best_score:
                best_score, best_plan, best_k = score, plan, k

        if best_plan is None:
            return []
        groups: dict[int, list[Node]] = {}
        order: list[int] = []
        for idx, slot in best_plan:
            if slot not in groups:
                groups[slot] = []
                order.append(slot)
            groups[slot].append(nodes[idx])
        pipelines: list[Pipeline] = []
        for slot in order:
            pipe = self._build_pipeline(groups[slot])
            if pipe is not None:
                pipelines.append(pipe)
        return pipelines


def try_dynamic_join(
    allocator: BaseLayerAllocator, standby: list[Node]
) -> list[Pipeline]:
    """A node joined mid-serve: build new pipelines from standby if possible
    (reference dynamic_join + extend, layer_allocation.py:193-214,
    request_routing RR extend)."""
    return allocator.allocate(standby)


def layer_hosting_power(active: list[Node], num_layers: int) -> list[float]:
    """Per-layer hosting power (sum of 1/latency over nodes serving each
    layer) — the reference's LayerLoad heap, as a plain array."""
    power = [0.0] * num_layers
    for n in active:
        if not n.has_allocation:
            continue
        p = 1.0 / max(1e-9, n.layer_latency_ms())
        for layer in range(n.start_layer, min(n.end_layer, num_layers)):
            power[layer] += p
    return power


def assign_to_lightest_layers(
    node: Node, active: list[Node], num_layers: int
) -> bool:
    """Dynamic join for a node that cannot complete a new pipeline:
    replicate the lightest EXISTING stage range it can hold (reference
    ``BaseLayerAllocator.dynamic_join`` joining the lightest layer,
    layer_allocation.py:193-214). Dynamic routers walk exact stage
    boundaries, so a free-sliding window would be unreachable — the
    replica must adopt a range some path already uses. Returns False when
    no active stage fits the node's capacity.
    """
    cap = node.layer_capacity()
    power = layer_hosting_power(active, num_layers)
    best: tuple[int, int] | None = None
    best_avg = float("inf")
    for other in active:
        if not other.has_allocation:
            continue
        s, e = other.start_layer, min(other.end_layer, num_layers)
        if e - s < 1 or e - s > cap:
            continue
        avg = sum(power[s:e]) / (e - s)
        if avg < best_avg:
            best_avg, best = avg, (s, e)
    if best is None:
        return False
    node.set_layers(*best)
    return True


def trim_pipeline_boundaries(
    group: list[Node], counts: list[int], max_iter: int = 64
) -> list[int]:
    """Local search on stage boundaries after water-filling: repeatedly move
    one layer from the latency-bottleneck stage to its cheaper neighbor
    while that lowers the pipeline's max stage latency (the reference's
    turning-point trimming, layer_allocation.py:461-555 — water-filling is
    proportional in the continuous relaxation; integer rounding leaves
    boundary slack this pass reclaims).
    """
    counts = list(counts)
    lat = [n.layer_latency_ms() for n in group]
    caps = [n.layer_capacity() for n in group]

    def stage_ms(i: int) -> float:
        return counts[i] * lat[i]

    for _ in range(max_iter):
        worst = max(range(len(group)), key=stage_ms)
        if counts[worst] <= 1:
            break
        best_gain, best_nb = 0.0, None
        for nb in (worst - 1, worst + 1):
            if not 0 <= nb < len(group) or counts[nb] >= caps[nb]:
                continue
            old_max = max(stage_ms(worst), stage_ms(nb))
            new_max = max(
                (counts[worst] - 1) * lat[worst],
                (counts[nb] + 1) * lat[nb],
            )
            if old_max - new_max > best_gain:
                best_gain, best_nb = old_max - new_max, nb
        if best_nb is None:
            break
        counts[worst] -= 1
        counts[best_nb] += 1
    return counts
