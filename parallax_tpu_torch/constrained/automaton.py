"""Byte-level regular automata for constrained decoding.

Thompson-style NFA fragments composed programmatically (no regex-string
parser: the JSON-schema compiler in ``json_schema.py`` emits fragments
directly), then subset-constructed into a dense byte DFA.

The reference framework delegates grammar-constrained decoding to its CUDA
backends' grammar engines (SamplingParams carries ``json_schema``,
reference ``src/parallax/server/sampling/sampling_params.py``); this is the
framework-native equivalent: a DFA whose per-state token masks are computed
vectorized over the tokenizer vocabulary (``vocab.py``) and applied to the
logits on device.

Alphabet: bytes 0..255. State 0 of the DFA is the start state; the dead
state is -1 (absorbing, never materialized).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Nfa:
    """Mutable NFA under construction.

    ``trans[s]`` is a list of ``(lo, hi, target)`` byte-range edges;
    ``eps[s]`` a list of epsilon targets.
    """

    trans: list[list[tuple[int, int, int]]] = dataclasses.field(
        default_factory=list
    )
    eps: list[list[int]] = dataclasses.field(default_factory=list)

    def new_state(self) -> int:
        self.trans.append([])
        self.eps.append([])
        return len(self.trans) - 1

    def add_edge(self, src: int, lo: int, hi: int, dst: int) -> None:
        self.trans[src].append((lo, hi, dst))

    def add_eps(self, src: int, dst: int) -> None:
        self.eps[src].append(dst)


@dataclasses.dataclass(frozen=True)
class Frag:
    """An NFA fragment with single entry and single exit state."""

    start: int
    end: int


class Builder:
    """Fragment combinators over a shared NFA."""

    def __init__(self) -> None:
        self.nfa = Nfa()

    def epsilon(self) -> Frag:
        s = self.nfa.new_state()
        return Frag(s, s)

    def byte_range(self, lo: int, hi: int) -> Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_edge(s, lo, hi, e)
        return Frag(s, e)

    def byte_class(self, ranges: list[tuple[int, int]]) -> Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for lo, hi in ranges:
            self.nfa.add_edge(s, lo, hi, e)
        return Frag(s, e)

    def lit(self, data: bytes) -> Frag:
        if not data:
            return self.epsilon()
        s = self.nfa.new_state()
        cur = s
        for b in data:
            nxt = self.nfa.new_state()
            self.nfa.add_edge(cur, b, b, nxt)
            cur = nxt
        return Frag(s, cur)

    def seq(self, *frags: Frag) -> Frag:
        frags = [f for f in frags if f is not None]
        if not frags:
            return self.epsilon()
        for a, b in zip(frags, frags[1:]):
            self.nfa.add_eps(a.end, b.start)
        return Frag(frags[0].start, frags[-1].end)

    def alt(self, *frags: Frag) -> Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for f in frags:
            self.nfa.add_eps(s, f.start)
            self.nfa.add_eps(f.end, e)
        return Frag(s, e)

    def opt(self, f: Frag) -> Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, f.start)
        self.nfa.add_eps(f.end, e)
        self.nfa.add_eps(s, e)
        return Frag(s, e)

    def star(self, f: Frag) -> Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, f.start)
        self.nfa.add_eps(f.end, f.start)
        self.nfa.add_eps(f.end, e)
        self.nfa.add_eps(s, e)
        return Frag(s, e)

    def plus(self, f: Frag) -> Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, f.start)
        self.nfa.add_eps(f.end, f.start)
        self.nfa.add_eps(f.end, e)
        return Frag(s, e)

    def sep_list(self, item: Frag, sep: Frag) -> Frag:
        """``item (sep item)*`` with a SINGLE copy of ``item``: the loop
        runs backwards through ``sep`` via epsilon edges. Keeps bounded-
        depth recursive grammars (JSON) from duplicating whole subtrees
        per list position."""
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, item.start)
        self.nfa.add_eps(item.end, e)
        self.nfa.add_eps(item.end, sep.start)
        self.nfa.add_eps(sep.end, item.start)
        return Frag(s, e)

    def repeat(self, make, lo: int, hi: int) -> Frag:
        """``make()`` returns a fresh fragment each call (fragments are
        single-use); concatenate ``lo`` mandatory + ``hi-lo`` optional."""
        parts = [make() for _ in range(lo)]
        parts += [self.opt(make()) for _ in range(hi - lo)]
        return self.seq(*parts) if parts else self.epsilon()


class Dfa:
    """Dense byte DFA: ``table[s * 256 + b]`` -> next state or -1."""

    __slots__ = ("table", "accepting", "n_states")

    def __init__(self, table, accepting, n_states):
        self.table = table            # np.int32 [n_states * 256]
        self.accepting = accepting    # np.bool_ [n_states]
        self.n_states = n_states

    def next_state(self, state: int, byte: int) -> int:
        if state < 0:
            return -1
        return int(self.table[state * 256 + byte])

    def matches(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = self.next_state(s, b)
            if s < 0:
                return False
        return bool(self.accepting[s])


MAX_DFA_STATES = 20_000


def compile_dfa(builder: Builder, frag: Frag) -> Dfa:
    """Subset construction over the byte alphabet.

    Raises ValueError if the DFA exceeds MAX_DFA_STATES (pathological
    schema; the caller maps this to an HTTP 400).
    """
    import numpy as np

    nfa = builder.nfa

    def eclose(states: frozenset[int]) -> frozenset[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start = eclose(frozenset([frag.start]))
    index: dict[frozenset[int], int] = {start: 0}
    order: list[frozenset[int]] = [start]
    rows: list[np.ndarray] = []

    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        # Split the byte space at all edge boundaries of the member states.
        cuts = {0, 256}
        edges = []
        for s in cur:
            for lo, hi, dst in nfa.trans[s]:
                cuts.add(lo)
                cuts.add(hi + 1)
                edges.append((lo, hi, dst))
        row = np.full(256, -1, np.int32)
        bounds = sorted(cuts)
        for lo_b, hi_b in zip(bounds, bounds[1:]):
            targets = frozenset(
                dst for lo, hi, dst in edges if lo <= lo_b and lo_b <= hi
            )
            if not targets:
                continue
            closed = eclose(targets)
            if closed not in index:
                if len(index) >= MAX_DFA_STATES:
                    raise ValueError(
                        "grammar too complex: DFA state cap exceeded"
                    )
                index[closed] = len(order)
                order.append(closed)
            row[lo_b:hi_b] = index[closed]
        rows.append(row)

    accepting = np.array(
        [frag.end in states for states in order], np.bool_
    )
    table = np.concatenate(rows) if rows else np.full(256, -1, np.int32)
    return Dfa(table, accepting, len(order))
