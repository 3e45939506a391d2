"""Tokenizer vocabulary -> DFA transition tables, vectorized.

For each DFA state the matcher needs (lazily, as decoding visits states):
  - ``mask``: bool[V] — tokens whose whole byte string keeps the DFA alive
  - ``next``: int32[V] — resulting DFA state per token (-1 = dead)

Computed with one numpy sweep over byte positions: a [V] state vector
steps through ``dfa.table`` per byte column, dead states absorbing. Cost
O(max_token_len * V) ≈ a few ms per state; decode paths revisit a small
working set of states, so the per-state cache makes this negligible.

Token byte strings come from the tokenizer. Byte-level BPE vocabularies
(GPT-2/Qwen/Llama-3 style) store tokens in the printable remap alphabet;
``byte_level_decoder`` inverts the standard GPT-2 byte<->unicode table.
SentencePiece-style vocabs use U+2581 for space and are handled by the
fallback ``tokenizer.decode`` path in ``vocab_bytes_from_tokenizer``.
"""

from __future__ import annotations

import functools

import numpy as np

from parallax_tpu_torch.constrained.automaton import Dfa


@functools.lru_cache(maxsize=1)
def _gpt2_byte_decoder() -> dict[str, int]:
    """The standard byte-level-BPE unicode remap, inverted."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def vocab_bytes_from_tokenizer(tok) -> list[bytes]:
    """Token id -> raw byte string, for every id in [0, vocab size)."""
    # Unwrap the serving shim (backend.http_server._HF) if present.
    inner = getattr(tok, "_tok", None) or getattr(tok, "tok", None) or tok
    if hasattr(inner, "vocab_bytes"):
        return list(inner.vocab_bytes())
    size = max(
        int(getattr(inner, "vocab_size", 0) or 0),
        len(getattr(inner, "get_vocab", dict)() or {}),
    )
    decoder = _gpt2_byte_decoder()
    out: list[bytes] = [b""] * size
    vocab = inner.get_vocab() if hasattr(inner, "get_vocab") else {}
    # Marker-based dialect detection (plain ASCII exists in BOTH dialects,
    # so membership in the byte-level remap alphabet proves nothing):
    # byte-level BPE remaps space to U+0120 'Ġ' / newline to U+010A 'Ċ';
    # SentencePiece marks word boundaries with U+2581 '▁' and carries raw
    # bytes as '<0xNN>' tokens.
    byte_level = any("Ġ" in t or "Ċ" in t for t in vocab)
    sentencepiece = not byte_level and any("▁" in t for t in vocab)
    DEAD = b"\x00\xff<special>"
    if byte_level:
        for token, idx in vocab.items():
            if 0 <= idx < size:
                if token.startswith("<|") and token.endswith("|>"):
                    # Control-token surface form (pure ASCII, so the byte
                    # decoder would map it to its literal text, which the
                    # detokenizer never emits): must be unsampleable.
                    out[idx] = DEAD
                    continue
                try:
                    out[idx] = bytes(decoder[ch] for ch in token)
                except KeyError:
                    # Special token outside the remap alphabet: never
                    # valid inside JSON output.
                    out[idx] = DEAD
    elif sentencepiece:
        for token, idx in vocab.items():
            if not 0 <= idx < size:
                continue
            if (
                len(token) == 6
                and token.startswith("<0x")
                and token.endswith(">")
            ):
                try:
                    out[idx] = bytes([int(token[3:5], 16)])
                    continue
                except ValueError:
                    pass
            if token.startswith("<") and token.endswith(">"):
                out[idx] = DEAD
            else:
                out[idx] = token.replace("▁", " ").encode("utf-8")
    else:
        for idx in range(size):
            try:
                out[idx] = inner.decode([idx]).encode("utf-8")
            except Exception:
                out[idx] = DEAD
    # Tokenizer-declared specials (eos/bos/pad/added control tokens) are
    # never emitted as text by the detokenizer — kill them regardless of
    # how their surface form mapped above.
    for sid in getattr(inner, "all_special_ids", None) or ():
        if 0 <= sid < size:
            out[sid] = DEAD
    added = getattr(inner, "get_added_vocab", dict)() or {}
    for _tok, sid in added.items():
        if 0 <= sid < size:
            out[sid] = DEAD
    return out


class TokenTable:
    """Per-DFA-state token masks/transitions over a fixed vocabulary."""

    def __init__(self, dfa: Dfa, vocab: list[bytes], eos_token_id: int):
        self.dfa = dfa
        self.eos_token_id = int(eos_token_id)
        self.vocab_size = len(vocab)
        max_len = max((len(v) for v in vocab), default=1)
        self._bytes = np.zeros((self.vocab_size, max_len), np.uint8)
        self._lens = np.zeros((self.vocab_size,), np.int32)
        for i, v in enumerate(vocab):
            self._lens[i] = len(v)
            if v:
                self._bytes[i, : len(v)] = np.frombuffer(v, np.uint8)
        # Zero-length tokens (unused ids) must never be sampled: they would
        # commit without advancing the grammar. Treat as dead below.
        self._table = dfa.table.reshape(dfa.n_states, 256)
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _compute(self, state: int) -> tuple[np.ndarray, np.ndarray]:
        states = np.full((self.vocab_size,), state, np.int64)
        max_len = self._bytes.shape[1]
        for pos in range(max_len):
            active = (self._lens > pos) & (states >= 0)
            if not active.any():
                break
            nxt = self._table[states[active], self._bytes[active, pos]]
            states[active] = nxt
        states[self._lens == 0] = -1
        mask = states >= 0
        nxt = states.astype(np.int32)
        nxt[~mask] = -1
        return mask, nxt

    def lookup(self, state: int) -> tuple[np.ndarray, np.ndarray]:
        hit = self._cache.get(state)
        if hit is None:
            hit = self._compute(state)
            self._cache[state] = hit
        return hit

    def allowed_mask(self, state: int) -> np.ndarray:
        """bool[V] of sampleable tokens; EOS allowed iff accepting."""
        mask, _ = self.lookup(state)
        out = mask.copy()
        if state >= 0 and bool(self.dfa.accepting[state]):
            out[self.eos_token_id] = True
        if not out.any():
            # Failsafe: grammar wedged (shouldn't happen) — allow EOS so
            # the request terminates instead of spinning.
            out[self.eos_token_id] = True
        return out

    def advance(self, state: int, token_id: int) -> int:
        if token_id == self.eos_token_id:
            return state
        _, nxt = self.lookup(state)
        if 0 <= token_id < self.vocab_size:
            return int(nxt[token_id])
        return -1

    def is_accepting(self, state: int) -> bool:
        return state >= 0 and bool(self.dfa.accepting[state])
