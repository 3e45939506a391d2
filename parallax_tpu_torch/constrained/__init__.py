"""Grammar-constrained decoding (JSON mode / json_schema): the port's copy
of ``parallax_tpu/constrained/`` (pure Python and numpy; the port keeps
its own copy so it imports nothing of the JAX package).

Pipeline: JSON schema -> byte NFA (``json_schema.py``) -> dense byte DFA
(``automaton.py``) -> per-state vocab masks (``vocab.py``) -> logit mask
applied in the last stage's sampler (``runtime/engine.py``), or the dense
packed tables (``device_table.py``) a decode window gathers from on the
device.
"""

from __future__ import annotations

import threading

from parallax_tpu_torch.constrained.automaton import Dfa, compile_dfa
from parallax_tpu_torch.constrained.device_table import (
    DEVICE_TABLE_MAX_CELLS,
    DeviceGrammarTable,
    build_device_table,
)
from parallax_tpu_torch.constrained.json_schema import SchemaError, compile_schema
from parallax_tpu_torch.constrained.vocab import TokenTable, vocab_bytes_from_tokenizer
from parallax_tpu_torch.analysis.sanitizer import make_lock

__all__ = [
    "DEVICE_TABLE_MAX_CELLS",
    "DeviceGrammarTable",
    "Dfa",
    "GrammarCompiler",
    "SchemaError",
    "TokenTable",
    "build_device_table",
    "compile_dfa",
    "compile_schema",
    "grammar_cache_key",
    "grammar_state_hash",
    "grammar_vocab_from_tokenizer",
    "validate_schema",
    "vocab_bytes_from_tokenizer",
]


import functools


def grammar_vocab_from_tokenizer(tok) -> tuple[list[bytes], int]:
    """Shared tokenizer -> (vocab bytes, eos id) derivation for grammar
    wiring.

    Raises ValueError when enforcement cannot be sound — in particular for
    tokenizers without an EOS id: the mask layer would otherwise have to
    fabricate one, letting a real token pass at accepting states without
    ever finishing the request.
    """
    eos = tuple(getattr(tok, "eos_token_ids", ()) or ())
    if not eos:
        raise ValueError("tokenizer has no EOS id")
    return vocab_bytes_from_tokenizer(tok), eos[0]


def grammar_cache_key(schema_json: str) -> str:
    """THE canonical schema key: every cache (token tables, device
    tables, per-request states) and the checkpoint hash derive from the
    stripped schema string, so one request's grammar identity is stable
    across compilers, stages and migrations."""
    return schema_json.strip() or "{}"


def grammar_state_hash(schema_json: str) -> str:
    """Short content hash of a grammar for checkpoint validation: a
    migrated-in ``dfa_state`` is only trusted when the restoring stage
    compiled the SAME grammar (state numbering is a function of the
    schema text)."""
    import hashlib

    return hashlib.sha256(
        grammar_cache_key(schema_json).encode("utf-8")
    ).hexdigest()[:16]


@functools.lru_cache(maxsize=64)
def validate_schema(schema_json: str) -> None:
    """Frontend-side admission check: compile (and discard) the DFA so an
    unsupported schema 400s before any tokens are spent. Successes are
    cached; the engine's GrammarCompiler re-uses its own cache for the
    vocab-bound table."""
    compile_schema(schema_json)


class GrammarCompiler:
    """Schema-string -> TokenTable with caching, bound to one vocabulary."""

    def __init__(self, vocab: list[bytes], eos_token_id: int,
                 max_cached: int = 32):
        self._vocab = vocab
        self._eos = int(eos_token_id)
        self._max = max_cached
        self._cache: dict[str, TokenTable] = {}
        # Dense device tables (device_table.py), built from the token
        # table once per grammar; None records an over-budget grammar so
        # the size check never reruns.
        self._dev_cache: dict[str, DeviceGrammarTable | None] = {}
        self._lock = make_lock("constrained.grammar")

    def compile(self, schema_json: str) -> TokenTable:
        key = grammar_cache_key(schema_json)
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        dfa = compile_schema(key)          # raises SchemaError on bad input
        table = TokenTable(dfa, self._vocab, self._eos)
        with self._lock:
            if len(self._cache) >= self._max:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = table
        return table

    def device_table(
        self, schema_json: str
    ) -> tuple[DeviceGrammarTable | None, bool]:
        """(dense device table | None, built-this-call) for a grammar.
        None = the state×vocab product exceeds DEVICE_TABLE_MAX_CELLS
        and the grammar stays on the host-sync path. The bool feeds the
        engine's table-build vs cache-hit counters."""
        key = grammar_cache_key(schema_json)
        with self._lock:
            if key in self._dev_cache:
                return self._dev_cache[key], False
        dev = build_device_table(self.compile(schema_json))
        with self._lock:
            if len(self._dev_cache) >= self._max:
                self._dev_cache.pop(next(iter(self._dev_cache)))
            self._dev_cache[key] = dev
        return dev, True

    def device_table_bytes(self) -> int:
        """Total bytes held by cached dense grammar tables."""
        with self._lock:
            return sum(
                t.nbytes() for t in self._dev_cache.values()
                if t is not None
            )
