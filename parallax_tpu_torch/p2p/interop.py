"""Heterogeneous-swarm message interop: the reference protobuf wire (port
of ``parallax_tpu/p2p/interop.py``).

The reference swarm's CUDA / SGLang, vLLM and MLX nodes exchange
``ForwardRequest`` / ``AbortRequest`` protobuf messages with
safetensors-serialized hidden states under the key ``"tensor"``. This
module encodes the port's :class:`IntermediateRequest` into those bytes
and decodes them back, so a reference-protocol stage exchanges
activations with a port stage through any byte transport; ``WorkerNode``
takes the raw bytes on its FORWARD / ABORT handlers.

The messages go through ``p2p/protowire.py`` (the port's own proto3
codec: the card has no ``protobuf``) and the tensors through the port's
own safetensors codec: :func:`tensor_to_safetensors` writes an 8-byte
little-endian header length, the JSON header padded with spaces to a
multiple of 8, and the raw bytes, as ``safetensors.torch.save`` does;
:func:`tensor_from_safetensors` reads them with the checkpoint loader's
reader. A tensor keeps its dtype both ways (bf16 round-trips bitwise,
where the JAX module hands numpy an f32 upcast).

The mapping is the JAX module's: ``input_ids`` carries the prompt and
``output_length`` the rest of the context, a decode row's fed token
rides ``next_token_id``, each row's phase comes from its shape and
``output_length``, and every decoded hop is flagged ``is_last_chunk``
(the schema has no chunked-prefill continuation flag). One difference:
where ``input_ids`` spans the whole context and a hop's rows start past
position 0 (the head's prefix cache skipped that much), the decoder puts
the skipped ids in ``cached_prefix_ids``, so a new mirror computes at the
right positions. The JAX decoder drops them (ROADMAP queue 3). The
schema carries no seed, logit bias or logprob count: a seeded row arrives
unseeded.
"""

from __future__ import annotations

import json
from typing import Iterable

import torch

from parallax_tpu_torch.models.loader import SafetensorsFile
from parallax_tpu_torch.p2p import protowire
from parallax_tpu_torch.runtime.request import (
    IntermediateRequest,
    SamplingParams,
)

_ST_NAMES = {
    torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
}
_ST_KEY = "tensor"


# -- tensors -------------------------------------------------------------------


def tensor_to_safetensors(t: torch.Tensor) -> bytes:
    """One CPU tensor as safetensors bytes under ``"tensor"`` (the
    reference's ``tensor_to_bytes``)."""
    if t.device.type != "cpu":
        raise ValueError(f"tensor_to_safetensors takes CPU tensors, got "
                         f"{t.device}")
    name = _ST_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"no safetensors codec for {t.dtype} here")
    t = t.contiguous()
    data = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    header = json.dumps(
        {_ST_KEY: {"dtype": name, "shape": list(t.shape),
                   "data_offsets": [0, len(data)]}},
        separators=(",", ":")).encode()
    header += b" " * (-len(header) % 8)
    return len(header).to_bytes(8, "little") + header + data


def tensor_from_safetensors(data: bytes) -> torch.Tensor:
    """The reference's ``bytes_to_tensor``: the ``"tensor"`` entry of
    safetensors bytes, in its own dtype, on the CPU."""
    return SafetensorsFile.from_bytes(data).get_tensor(_ST_KEY)


# -- sampling params -------------------------------------------------------------


def sampling_to_proto(sp: dict | SamplingParams | None) -> dict:
    """A ``SamplingParams`` message (as a protowire dict)."""
    if isinstance(sp, SamplingParams):
        sp = sp.to_dict()
    sp = sp or {}
    return {
        "max_new_tokens": int(sp.get("max_new_tokens", 128)),
        "min_new_tokens": int(sp.get("min_new_tokens", 0)),
        "temperature": float(sp.get("temperature", 1.0)),
        "top_p": float(sp.get("top_p", 1.0)),
        "min_p": float(sp.get("min_p", 0.0)),
        "top_k": int(sp.get("top_k", -1)),
        "stop_token_ids": [int(t) for t in sp.get("stop_token_ids") or ()],
        "ignore_eos": bool(sp.get("ignore_eos", False)),
        "stop_strs": list(sp.get("stop_strings") or ()),
        "repetition_penalty": float(sp.get("repetition_penalty", 1.0)),
        "presence_penalty": float(sp.get("presence_penalty", 0.0)),
        "frequency_penalty": float(sp.get("frequency_penalty", 0.0)),
        "json_schema": sp.get("json_schema") or "",
    }


def sampling_from_proto(p: dict | None) -> dict:
    """To the port's wire dict (``SamplingParams.from_dict`` form); the
    fields the reference wire cannot carry (seed, logit bias, logprobs)
    default."""
    p = p or protowire.decode("SamplingParams", b"")
    return dict(
        max_new_tokens=p["max_new_tokens"] or 128,
        min_new_tokens=p["min_new_tokens"],
        temperature=p["temperature"],
        top_p=p["top_p"] if p["top_p"] > 0 else 1.0,
        min_p=p["min_p"],
        top_k=p["top_k"] if p["top_k"] != 0 else -1,
        stop_token_ids=list(p["stop_token_ids"]),
        ignore_eos=p["ignore_eos"],
        stop_strings=list(p["stop_strs"]),
        repetition_penalty=p["repetition_penalty"] or 1.0,
        presence_penalty=p["presence_penalty"],
        frequency_penalty=p["frequency_penalty"],
        json_schema=p["json_schema"] or None,
    )


# -- ForwardRequest ------------------------------------------------------------


def _is_prefill(i: IntermediateRequest) -> bool:
    return not i.abort and (
        i.num_new_tokens > 1 or i.context_len == i.num_new_tokens
    )


def ireqs_to_forward_bytes(
    ireqs: list[IntermediateRequest],
    full_input_ids: dict[str, list[int]] | None = None,
) -> bytes:
    """A batch of packets as a reference ``ForwardRequest``.

    ``input_ids`` carries each request's prompt and ``output_length``
    the rest of the context (``len(input_ids) + output_length`` is the
    context length). The packets carry only their new tokens, so the
    caller gives each request's prompt in ``full_input_ids`` (the head
    has it); without it the packet's own ids (with its skipped prefix)
    stand in and ``output_length`` keeps the context length exact."""
    kinds = {_is_prefill(i) for i in ireqs}
    reqs = []
    for ireq in ireqs:
        ids = (full_input_ids or {}).get(ireq.request_id)
        if ids is None:
            ids = list(ireq.cached_prefix_ids or []) + list(
                ireq.token_ids or [])
        r = {
            "rid": ireq.request_id,
            "output_length": ireq.context_len - len(ids),
            "routing_table": list(ireq.routing_table or []),
            "input_ids": [int(t) for t in ids],
            "sampling_params": sampling_to_proto(ireq.sampling_params),
            "lora_path": ireq.lora_id or "",
        }
        if ireq.hidden_states is not None:
            r["hidden_states"] = tensor_to_safetensors(ireq.hidden_states)
        if ireq.next_token_id is not None:
            r["next_token_id"] = int(ireq.next_token_id)
        elif not _is_prefill(ireq) and ireq.token_ids:
            # A decode packet's fed token: the reference wire carries it in
            # next_token_id (input_ids stays the prompt).
            r["next_token_id"] = int(ireq.token_ids[-1])
        if ireq.token_logprob is not None:
            r["token_prob"] = float(ireq.token_logprob)
        sp = ireq.sampling_params or {}
        r["return_probs"] = bool(
            (sp.get("logprobs") if isinstance(sp, dict) else sp.logprobs)
            or ireq.token_logprob is not None
        )
        reqs.append(r)
    mode = (protowire.MIXED if len(kinds) > 1
            else protowire.EXTEND if True in kinds else protowire.DECODE)
    return protowire.encode("ForwardRequest",
                            {"forward_mode": mode, "reqs": reqs})


def forward_bytes_to_ireqs(data: bytes) -> list[IntermediateRequest]:
    """A reference ``ForwardRequest`` as the port's packets: the context
    length is ``len(input_ids) + output_length``; a row without hidden
    states is a ring-closure packet whose ``next_token_id`` the head
    commits."""
    msg = protowire.decode("ForwardRequest", data)
    mode = msg["forward_mode"]
    out: list[IntermediateRequest] = []
    for r in msg["reqs"]:
        hidden = (tensor_from_safetensors(r["hidden_states"])
                  if r["hidden_states"] else None)
        if hidden is not None and hidden.ndim == 1:
            hidden = hidden[None, :]
        current_position = len(r["input_ids"]) + r["output_length"]
        sampling = dict(sampling_from_proto(r["sampling_params"]),
                        logprobs=bool(r["return_probs"]))
        common = dict(request_id=r["rid"],
                      routing_table=list(r["routing_table"]),
                      context_len=current_position,
                      token_logprob=r["token_prob"],
                      sampling_params=sampling,
                      lora_id=r["lora_path"] or None)
        if hidden is None:
            out.append(IntermediateRequest(
                num_new_tokens=0, next_token_id=r["next_token_id"],
                **common))
            continue
        n_new = int(hidden.shape[0])
        # Per-row phase: a MIXED batch carries both kinds. A decode row
        # has one hidden row and generated tokens behind it.
        decode = mode == protowire.DECODE or (
            mode == protowire.MIXED and r["output_length"] > 0
            and n_new == 1)
        ids = list(r["input_ids"])
        if decode:
            tail = [int(r["next_token_id"])]
        elif len(ids) >= current_position:
            # The hop covers the tail of the context, input_ids positioned
            # absolutely (a reference encoder).
            tail = ids[current_position - n_new:current_position] or None
        elif len(ids) >= n_new:
            # A fallback encoding packs only the chunk's own tokens: the
            # payload IS the tail.
            tail = ids[-n_new:]
        else:
            tail = None
        # input_ids spanning the whole context of a hop whose rows start
        # past position 0: the head's prefix cache skipped those ids. (A
        # prompt's one-token hop is encoded as a decode row.)
        prefix = (ids[:current_position - n_new] or None
                  if len(ids) >= current_position else None)
        out.append(IntermediateRequest(
            num_new_tokens=n_new, token_ids=tail, hidden_states=hidden,
            is_last_chunk=True, cached_prefix_ids=prefix, **common))
    return out


# -- AbortRequest ----------------------------------------------------------------


def rids_to_abort_bytes(rids: Iterable[str]) -> bytes:
    return protowire.encode("AbortRequest",
                            {"reqs": [{"rid": rid} for rid in rids]})


def abort_bytes_to_rids(data: bytes) -> list[str]:
    return [r["rid"] for r in protowire.decode("AbortRequest", data)["reqs"]]
