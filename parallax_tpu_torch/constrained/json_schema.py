"""Compile a JSON Schema (practical subset) to a byte-level DFA.

Supported subset (unsupported constructs raise ValueError -> HTTP 400):
- type: object / array / string / number / integer / boolean / null
- object: properties (emitted in declaration order), required,
  additionalProperties: false implied (order-fixed emission is the
  standard trick for regular-grammar JSON constrained decoding)
- array: items, minItems / maxItems (unbounded count allowed)
- enum / const of scalar values
- string: minLength / maxLength (bounded), no pattern/format
- anyOf / oneOf of supported schemas
- {} or true: any JSON value (nesting bounded at MAX_DEPTH)

Escape-complete JSON string bytes, standard number grammar, minimal
whitespace (none emitted between tokens — the model may still produce
spaces inside strings; inter-token whitespace is allowed sparsely via
``_ws`` so common formatting survives).
"""

from __future__ import annotations

import json

from parallax_tpu_torch.constrained.automaton import Builder, Dfa, Frag, compile_dfa

MAX_DEPTH = 6          # bounded nesting for the "any JSON" grammar
MAX_WS = 2             # max consecutive whitespace bytes between tokens


class SchemaError(ValueError):
    """Unsupported or invalid schema construct."""


def _ws(b: Builder) -> Frag:
    """Up to MAX_WS whitespace bytes (space/tab/newline/cr)."""
    return b.repeat(
        lambda: b.byte_class([(0x09, 0x0A), (0x0D, 0x0D), (0x20, 0x20)]),
        0, MAX_WS,
    )


def _string_body(b: Builder) -> Frag:
    """One JSON string character: plain byte or escape sequence.

    Plain: any byte except '"' (0x22), '\\' (0x5C) and C0 controls.
    Multi-byte UTF-8 continuation bytes are admitted byte-wise (lenient:
    token byte streams are valid UTF-8 in practice).
    """
    plain = b.byte_class([(0x20, 0x21), (0x23, 0x5B), (0x5D, 0xFF)])
    hexd = [(0x30, 0x39), (0x41, 0x46), (0x61, 0x66)]
    esc_simple = b.seq(
        b.lit(b"\\"),
        b.byte_class([
            (0x22, 0x22), (0x2F, 0x2F), (0x5C, 0x5C), (0x62, 0x62),
            (0x66, 0x66), (0x6E, 0x6E), (0x72, 0x72), (0x74, 0x74),
        ]),
    )
    esc_u = b.seq(
        b.lit(b"\\u"),
        b.byte_class(hexd), b.byte_class(hexd),
        b.byte_class(hexd), b.byte_class(hexd),
    )
    return b.alt(plain, esc_simple, esc_u)


def _string(b: Builder, schema: dict) -> Frag:
    min_len = int(schema.get("minLength", 0))
    max_len = schema.get("maxLength")
    if max_len is None:
        body = b.star(_string_body(b))
        if min_len:
            body = b.seq(
                b.repeat(lambda: _string_body(b), min_len, min_len), body
            )
    else:
        max_len = int(max_len)
        if max_len < min_len:
            raise SchemaError("maxLength < minLength")
        body = b.repeat(lambda: _string_body(b), min_len, max_len)
    return b.seq(b.lit(b'"'), body, b.lit(b'"'))


def _digits(b: Builder) -> Frag:
    return b.plus(b.byte_range(0x30, 0x39))


def _number(b: Builder, integer: bool = False) -> Frag:
    int_part = b.alt(
        b.lit(b"0"),
        b.seq(b.byte_range(0x31, 0x39), b.star(b.byte_range(0x30, 0x39))),
    )
    frag = b.seq(b.opt(b.lit(b"-")), int_part)
    if not integer:
        frac = b.opt(b.seq(b.lit(b"."), _digits(b)))
        expo = b.opt(b.seq(
            b.byte_class([(0x45, 0x45), (0x65, 0x65)]),
            b.opt(b.byte_class([(0x2B, 0x2B), (0x2D, 0x2D)])),
            _digits(b),
        ))
        frag = b.seq(frag, frac, expo)
    return frag


def _const(b: Builder, value) -> Frag:
    return b.lit(json.dumps(value, ensure_ascii=True).encode())


def _object(b: Builder, schema: dict, depth: int) -> Frag:
    props = schema.get("properties", {})
    required = set(schema.get("required", []))
    unknown = required - set(props)
    if unknown:
        raise SchemaError(f"required properties not declared: {unknown}")
    if not props:
        # Free-form object. ONE pair fragment reused via sep_list: per
        # nesting level the value subtree is built once here (and once in
        # _array), keeping total NFA size O(2^depth), not O(4^depth).
        if depth <= 0:
            return b.lit(b"{}")
        pair = b.seq(
            _ws(b), _string(b, {}), _ws(b), b.lit(b":"), _ws(b),
            _value(b, {}, depth - 1),
        )
        inner = b.opt(b.sep_list(pair, b.seq(_ws(b), b.lit(b","))))
        return b.seq(b.lit(b"{"), inner, _ws(b), b.lit(b"}"))

    # Declaration-order emission: required props mandatory, optional props
    # optional. Comma placement handled by tracking "first emitted":
    # regular languages can't count, so we enumerate the optional subsets
    # positionally — each optional property becomes opt(", key: value")
    # after the first mandatory anchor, and if no required property exists
    # the first property slot is an alternation over which property leads.
    entries = list(props.items())

    def entry_frag(name: str, sub: dict, lead: bool) -> Frag:
        body = b.seq(
            _ws(b), b.lit(json.dumps(name).encode()), _ws(b),
            b.lit(b":"), _ws(b), _value(b, sub, depth - 1),
        )
        if lead:
            return body
        return b.seq(_ws(b), b.lit(b","), body)

    req_idx = [i for i, (n, _) in enumerate(entries) if n in required]
    if req_idx:
        first_req = req_idx[0]
        parts: list[Frag] = []
        # Optional properties before the first required one would need a
        # trailing comma decided by lookahead — emit them after instead.
        head = [e for i, e in enumerate(entries)
                if i < first_req and e[0] not in required]
        ordered = (
            [entries[first_req]]
            + [e for i, e in enumerate(entries)
               if i != first_req and e[0] in required]
            + head
            + [e for e in entries
               if e[0] not in required and e not in head]
        )
        for j, (name, sub) in enumerate(ordered):
            f = entry_frag(name, sub or {}, lead=(j == 0))
            if name not in required:
                f = b.opt(f)
            parts.append(f)
        inner = b.seq(*parts)
    else:
        # All optional: alternate over which property appears first,
        # followed by the later ones (order preserved), or empty.
        alts = []
        for i, (name, sub) in enumerate(entries):
            tail = [
                b.opt(entry_frag(n2, s2 or {}, lead=False))
                for (n2, s2) in entries[i + 1:]
            ]
            alts.append(b.seq(
                entry_frag(name, sub or {}, lead=True), *tail
            ))
        inner = b.opt(b.alt(*alts)) if alts else b.epsilon()
    return b.seq(b.lit(b"{"), inner, _ws(b), b.lit(b"}"))


def _array(b: Builder, schema: dict, depth: int) -> Frag:
    items = schema.get("items", {})
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if hi is not None and int(hi) < lo:
        raise SchemaError("maxItems < minItems")
    if depth <= 0:
        return b.lit(b"[]") if lo == 0 else _fail(b)
    item = lambda: b.seq(_ws(b), _value(b, items, depth - 1))  # noqa: E731
    rest = lambda: b.seq(_ws(b), b.lit(b","), item())          # noqa: E731
    if hi is None and lo <= 1:
        # Unbounded count: ONE item fragment looped via sep_list — a
        # counted expansion here would duplicate the whole item subtree
        # per position and blow the NFA up combinatorially with nesting.
        inner = b.sep_list(item(), b.seq(_ws(b), b.lit(b",")))
        if lo == 0:
            inner = b.opt(inner)
    elif hi is None:
        inner = b.seq(
            item(), b.repeat(rest, lo - 1, lo - 1),
            b.star(rest()),
        )
    else:
        hi = int(hi)
        if hi == 0:
            return b.seq(b.lit(b"["), _ws(b), b.lit(b"]"))
        if lo == 0:
            inner = b.opt(b.seq(item(), b.repeat(rest, 0, hi - 1)))
        else:
            inner = b.seq(item(), b.repeat(rest, lo - 1, hi - 1))
    return b.seq(b.lit(b"["), inner, _ws(b), b.lit(b"]"))


def _fail(b: Builder) -> Frag:
    """A fragment matching nothing (dead branch)."""
    s, e = b.nfa.new_state(), b.nfa.new_state()
    return Frag(s, e)


def _value(b: Builder, schema, depth: int) -> Frag:
    if schema is True or schema == {} or schema is None:
        if depth <= 0:
            return b.alt(
                _string(b, {}), _number(b), b.lit(b"true"),
                b.lit(b"false"), b.lit(b"null"),
            )
        return b.alt(
            _string(b, {}), _number(b), b.lit(b"true"), b.lit(b"false"),
            b.lit(b"null"), _object(b, {}, depth), _array(b, {}, depth),
        )
    if not isinstance(schema, dict):
        raise SchemaError(f"unsupported schema: {schema!r}")
    if "const" in schema:
        return _const(b, schema["const"])
    if "enum" in schema:
        opts = schema["enum"]
        if not opts:
            raise SchemaError("empty enum")
        return b.alt(*[_const(b, v) for v in opts])
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return b.alt(*[_value(b, s, depth) for s in schema[key]])
    typ = schema.get("type")
    if isinstance(typ, list):
        return b.alt(*[
            _value(b, {**schema, "type": t}, depth) for t in typ
        ])
    if typ == "object":
        return _object(b, schema, depth)
    if typ == "array":
        return _array(b, schema, depth)
    if typ == "string":
        return _string(b, schema)
    if typ == "number":
        return _number(b)
    if typ == "integer":
        return _number(b, integer=True)
    if typ == "boolean":
        return b.alt(b.lit(b"true"), b.lit(b"false"))
    if typ == "null":
        return b.lit(b"null")
    if typ is None:
        return _value(b, True, depth)
    raise SchemaError(f"unsupported type: {typ!r}")


def compile_schema(schema_json: str) -> Dfa:
    """Compile a JSON-schema string (or "" / "{}" for any-JSON mode)."""
    schema = json.loads(schema_json) if schema_json.strip() else {}
    b = Builder()
    frag = _value(b, schema, MAX_DEPTH)
    # Allow surrounding whitespace: models often open with a newline.
    frag = b.seq(_ws(b), frag, _ws(b))
    return compile_dfa(b, frag)
