"""Dense DEVICE grammar tables: the whole DFA×vocab product, packed.

The lazy per-state :class:`~parallax_tpu_torch.constrained.vocab.TokenTable`
is the host-synchronous sampler's tool: it materializes one state's
mask/transition row at a time, because the host visits one state per
request per step. The fused K-step decode window cannot call back into
Python between its steps — it needs the ENTIRE automaton resident
in device memory so a row's DFA state can live as an int32 in the window's
carried state:

- ``trans``  i32[n_states + 1, V]: next state per (state, token). Row
  ``n_states`` is the appended DEAD sink (self-loop); every host-side
  ``-1`` maps onto it. The EOS column is the identity (EOS never
  advances the automaton — mirroring ``TokenTable.advance``), so the
  in-window advance is one unconditional gather.
- ``allowed`` u32[n_states + 1, ceil(V/32)]: per-state token masks as
  packed bitsets — 32x smaller than bool[V] rows, unpacked on the device
  with two vector ops. EOS-iff-accepting and the empty-mask EOS
  failsafe are baked in at build time, bit-for-bit the masks
  ``TokenTable.allowed_mask`` hands the host sampler.

Building sweeps ALL states at once with the same numpy byte-column walk
the per-state path uses (a [n_states, V] state matrix instead of a [V]
vector) — O(n_states * V * max_token_len), a one-time cost per grammar,
cached by the compiler. Grammars whose state×vocab product exceeds
``DEVICE_TABLE_MAX_CELLS`` return None and stay on the host-sync path
(a registered gate; see docs/decode_loop.md).

numpy-only by design: the torch-side unpack/advance helpers live in
``ops/sampling.py`` so this module stays importable from the torch-free
frontend paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from parallax_tpu_torch.constrained.vocab import TokenTable

# Largest (n_states + 1) * vocab_size product compiled to a device
# table: 2^25 cells = 128 MiB of i32 transitions + 4 MiB of packed
# masks. Beyond it the grammar decodes host-synchronously.
DEVICE_TABLE_MAX_CELLS = 1 << 25


def pack_bool_rows(mask: np.ndarray) -> np.ndarray:
    """bool[..., V] -> u32[..., ceil(V/32)] with bit ``t % 32`` of word
    ``t // 32`` holding token ``t`` — the layout the on-device unpack
    (``ops/sampling.unpack_token_masks``) expands."""
    v = mask.shape[-1]
    w = -(-v // 32)
    padded = np.zeros(mask.shape[:-1] + (w * 32,), bool)
    padded[..., :v] = mask
    bits = padded.reshape(mask.shape[:-1] + (w, 32)).astype(np.uint32)
    return np.bitwise_or.reduce(
        bits << np.arange(32, dtype=np.uint32), axis=-1
    )


@dataclasses.dataclass
class DeviceGrammarTable:
    """One grammar's dense device tables (host-side numpy; the engine
    uploads and caches the device copies per batch combination)."""

    trans: np.ndarray      # i32[n_states + 1, V]
    allowed: np.ndarray    # u32[n_states + 1, ceil(V/32)] packed masks
    n_states: int          # real DFA states; row n_states is DEAD
    vocab_size: int
    eos_token_id: int

    @property
    def dead_state(self) -> int:
        return self.n_states

    def device_state(self, host_state: int) -> int:
        """Host DFA state (-1 = dead) -> row index into the tables."""
        return host_state if 0 <= host_state < self.n_states else (
            self.n_states
        )

    def host_state(self, device_state: int) -> int:
        """Row index -> host DFA state (-1 = dead)."""
        return device_state if 0 <= device_state < self.n_states else -1

    def nbytes(self) -> int:
        return int(self.trans.nbytes + self.allowed.nbytes)


def build_device_table(
    table: TokenTable, max_cells: int = DEVICE_TABLE_MAX_CELLS
) -> DeviceGrammarTable | None:
    """Compile a TokenTable's automaton to dense device tables, or None
    when the state×vocab product exceeds ``max_cells``."""
    dfa = table.dfa
    n = int(dfa.n_states)
    v = int(table.vocab_size)
    if (n + 1) * v > max_cells:
        return None
    byte_table = table._table                 # i32[n, 256]
    tok_bytes = table._bytes                  # u8[V, max_len]
    tok_lens = table._lens                    # i32[V]
    # Every (state, token) pair at once: states[s, t] walks token t's
    # bytes from state s, dead (-1) absorbing — the all-states
    # generalization of TokenTable._compute's [V] sweep.
    states = np.broadcast_to(
        np.arange(n, dtype=np.int64)[:, None], (n, v)
    ).copy()
    for pos in range(tok_bytes.shape[1]):
        active = (tok_lens > pos)[None, :] & (states >= 0)
        if not active.any():
            break
        col = np.broadcast_to(tok_bytes[None, :, pos], (n, v))
        states[active] = byte_table[states[active], col[active]]
    # Zero-length tokens (unused ids) are dead: committing one would
    # never advance the grammar (same rule as the host table).
    states[:, tok_lens == 0] = -1
    mask = states >= 0                        # bool[n, V]

    trans = np.full((n + 1, v), n, np.int32)  # default: dead sink
    live = np.where(mask, states, n).astype(np.int32)
    trans[:n] = live
    eos = int(table.eos_token_id)
    if 0 <= eos < v:
        # EOS never advances the automaton (TokenTable.advance).
        trans[:, eos] = np.arange(n + 1, dtype=np.int32)

    allowed = np.zeros((n + 1, v), bool)
    allowed[:n] = mask
    if 0 <= eos < v:
        accepting = np.asarray(dfa.accepting[:n], bool)
        allowed[:n, eos] |= accepting
        # Failsafe: a wedged state (nothing sampleable) allows EOS so
        # the request terminates instead of spinning — including the
        # dead sink, whose mask is otherwise empty.
        allowed[~allowed.any(axis=1), eos] = True
    return DeviceGrammarTable(
        trans=trans,
        allowed=pack_bool_rows(allowed),
        n_states=n,
        vocab_size=v,
        eos_token_id=eos,
    )
