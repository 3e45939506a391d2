"""The port's copy of the grammar stack (``parallax_tpu_torch/constrained/``)
against ``parallax_tpu.constrained`` on the same schemas and vocabularies:
the DFA tables bitwise, every state's ``TokenTable.allowed_mask`` and
transitions, the packed dense device tables, cache keys and state hashes
as equal strings, both tokenizer dialects of ``vocab_bytes_from_tokenizer``,
and the same schemas refused. The schemas are those of
``tests/test_constrained.py`` and ``tests/test_constrained_window.py``."""

import json

import numpy as np
import pytest

from parallax_tpu import constrained as jc
from parallax_tpu.constrained import vocab as jvocab
from parallax_tpu_torch import constrained as pc
from parallax_tpu_torch.constrained import vocab as pvocab
from parallax_tpu_torch.constrained.automaton import Builder, compile_dfa

BYTE_VOCAB = [bytes([i]) for i in range(256)] + [b"", b""]
EOS = 257
SCHEMAS = {
    "required_object": {"type": "object",
                        "properties": {"name": {"type": "string"},
                                       "age": {"type": "integer"}},
                        "required": ["name", "age"]},
    "optional": {"type": "object",
                 "properties": {"a": {"type": "boolean"},
                                "b": {"type": "null"}}},
    "enum_const_anyof": {"anyOf": [{"enum": ["red", "green"]},
                                   {"const": 7}]},
    "bounded_array": {"type": "array", "items": {"type": "integer"},
                      "minItems": 1, "maxItems": 3},
    "unbounded_array": {"type": "array", "items": {"type": "boolean"}},
    "short_string": {"type": "string", "maxLength": 2},
    "number": {"type": "number"},
    "boolean": {"type": "boolean"},
    "window_schema": {"type": "object",
                      "properties": {"v": {"enum": ["x", "y"]}},
                      "required": ["v"]},
}
SCHEMA_TEXT = {k: json.dumps(v) for k, v in SCHEMAS.items()}
SCHEMA_TEXT["any_json"] = "{}"
# A BPE-like vocabulary: multi-byte tokens, empty ids, a dead special.
BPE_VOCAB = BYTE_VOCAB[:256] + [b'{"', b'":', b'"}', b"true", b"null",
                                b"  ", b"12", b"", b"\x00\xff<special>",
                                b"</s>"]
BPE_EOS = len(BPE_VOCAB) - 1


def _states(dfa):
    return range(dfa.n_states)


@pytest.mark.parametrize("name", sorted(SCHEMA_TEXT))
def test_dfa_tables_bitwise(name):
    j = jc.compile_schema(SCHEMA_TEXT[name])
    p = pc.compile_schema(SCHEMA_TEXT[name])
    assert p.n_states == j.n_states
    np.testing.assert_array_equal(np.asarray(p.table), np.asarray(j.table))
    np.testing.assert_array_equal(np.asarray(p.accepting),
                                  np.asarray(j.accepting))


@pytest.mark.parametrize("vocab,eos", [(BYTE_VOCAB, EOS),
                                       (BPE_VOCAB, BPE_EOS)],
                         ids=["bytes", "bpe"])
@pytest.mark.parametrize("name", sorted(SCHEMA_TEXT))
def test_token_tables_and_device_tables_bitwise(name, vocab, eos):
    """Every reachable state's mask and transitions, and the dense packed
    device tables, equal to JAX's."""
    jt = jc.GrammarCompiler(vocab, eos).compile(SCHEMA_TEXT[name])
    pt = pc.GrammarCompiler(vocab, eos).compile(SCHEMA_TEXT[name])
    states = list(_states(pt.dfa))[:400]
    for s in states + [-1]:
        np.testing.assert_array_equal(pt.allowed_mask(s), jt.allowed_mask(s))
        np.testing.assert_array_equal(pt.lookup(s)[1], jt.lookup(s)[1])
        assert pt.is_accepting(s) == jt.is_accepting(s)
    for tok in (0, 34, 123, eos, len(vocab), -1):
        assert pt.advance(0, tok) == jt.advance(0, tok)
    jd, _ = jc.GrammarCompiler(vocab, eos).device_table(SCHEMA_TEXT[name])
    pd, built = pc.GrammarCompiler(vocab, eos).device_table(
        SCHEMA_TEXT[name])
    assert built and (pd is None) == (jd is None)
    if pd is not None:
        np.testing.assert_array_equal(pd.trans, jd.trans)
        np.testing.assert_array_equal(pd.allowed, jd.allowed)
        assert pd.allowed.dtype == jd.allowed.dtype == np.uint32
        assert (pd.n_states, pd.vocab_size, pd.eos_token_id,
                pd.dead_state) == (jd.n_states, jd.vocab_size,
                                   jd.eos_token_id, jd.dead_state)
        assert pd.nbytes() == jd.nbytes()


def test_pack_bool_rows_and_budget_gate():
    rng = np.random.default_rng(0)
    for v in (1, 31, 32, 33, 258, 1000):
        mask = rng.random((3, v)) < 0.4
        np.testing.assert_array_equal(pc.device_table.pack_bool_rows(mask),
                                      jc.device_table.pack_bool_rows(mask))
    table = pc.GrammarCompiler(BYTE_VOCAB, EOS).compile(
        SCHEMA_TEXT["window_schema"])
    assert pc.build_device_table(table, max_cells=16) is None
    assert pc.build_device_table(table, pc.DEVICE_TABLE_MAX_CELLS) is not None
    assert pc.DEVICE_TABLE_MAX_CELLS == jc.DEVICE_TABLE_MAX_CELLS


def test_cache_keys_and_state_hashes():
    for text in list(SCHEMA_TEXT.values()) + ["", "  ", " {} "]:
        assert pc.grammar_cache_key(text) == jc.grammar_cache_key(text)
        assert pc.grammar_state_hash(text) == jc.grammar_state_hash(text)
    s = SCHEMA_TEXT["window_schema"]
    assert pc.grammar_state_hash(s) == pc.grammar_state_hash(" " + s)
    assert pc.grammar_state_hash(s) != pc.grammar_state_hash("{}")


@pytest.mark.parametrize("bad", [
    {"type": "object", "required": ["ghost"]}, {"type": "frobnicate"},
    {"enum": []}, {"type": "array", "items": {"type": "wat"}},
])
def test_same_schemas_refused(bad):
    text = json.dumps(bad)
    with pytest.raises(ValueError) as j_err:
        jc.validate_schema(text)
    with pytest.raises(ValueError) as p_err:
        pc.validate_schema(text)
    assert str(p_err.value) == str(j_err.value)
    assert isinstance(p_err.value, pc.SchemaError) == isinstance(
        j_err.value, jc.SchemaError)


def test_compiler_cache_and_eos_rules():
    gc = pc.GrammarCompiler(BYTE_VOCAB, EOS)
    assert gc.compile('{"type": "boolean"}') is gc.compile(
        ' {"type": "boolean"}')
    table = gc.compile('{"type": "boolean"}')
    mask0 = table.allowed_mask(0)
    assert not mask0[EOS] and not mask0[256]      # zero-length ids: dead
    state = 0
    for byt in b"true":
        state = table.advance(state, byt)
    assert table.allowed_mask(state)[EOS]
    assert table.advance(state, EOS) == state      # EOS never advances
    assert gc.device_table('{"type": "boolean"}')[1] is True
    assert gc.device_table('{"type": "boolean"}')[1] is False
    assert gc.device_table_bytes() > 0


def test_automaton_builder_matches():
    b = Builder()
    frag = b.seq(b.lit(b"ab"), b.star(b.lit(b"c")), b.opt(b.lit(b"d")))
    dfa = compile_dfa(b, frag)
    for text, ok in ((b"ab", True), (b"abccc", True), (b"abcd", True),
                     (b"abd c", False), (b"a", False)):
        assert dfa.matches(text) is ok


class _SP:
    vocab_size = 6

    def get_vocab(self):
        return {"<unk>": 0, "the": 1, "▁the": 2, "<0x20>": 3,
                "▁a": 4, "</s>": 5}


class _BL:
    vocab_size = 5
    all_special_ids = (4,)

    def get_vocab(self):
        return {"the": 0, "Ġthe": 1, "Ċ": 2, "<|im_end|>": 3,
                "x": 4}


class _Eos:
    eos_token_ids = (9,)

    def vocab_bytes(self):
        return [bytes([i]) for i in range(10)]


@pytest.mark.parametrize("tok", [_SP(), _BL()], ids=["sentencepiece",
                                                     "byte_level"])
def test_vocab_bytes_both_dialects(tok):
    got = pvocab.vocab_bytes_from_tokenizer(tok)
    assert got == jvocab.vocab_bytes_from_tokenizer(tok)
    assert any(b.startswith(b"\x00\xff") for b in got)


def test_grammar_vocab_from_tokenizer():
    assert pc.grammar_vocab_from_tokenizer(_Eos()) == (
        jc.grammar_vocab_from_tokenizer(_Eos()))
    with pytest.raises(ValueError, match="no EOS"):
        pc.grammar_vocab_from_tokenizer(_SP())
