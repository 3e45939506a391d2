"""Offline one-shot generation, no server, no scheduler (port of
``parallax_tpu/backend/generate.py``).

Load a checkpoint, apply the chat template, stream the generated text to
stdout, and report TTFT and decode throughput on stderr.
"""

from __future__ import annotations

import sys
import time

from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


def generate_main(args) -> int:
    from parallax_tpu_torch.backend.http_server import IncrementalDecoder
    from parallax_tpu_torch.config import load_config
    from parallax_tpu_torch.models.loader import load_stage_params
    from parallax_tpu_torch.models.registry import create_stage_model
    from parallax_tpu_torch.runtime.engine import (
        EngineConfig,
        StageEngine,
        drive_step,
    )
    from parallax_tpu_torch.runtime.request import Request, SamplingParams
    from parallax_tpu_torch.utils.hw import resolve_device
    from parallax_tpu_torch.utils.compile_cache import (
        enable_compilation_cache,
    )
    from parallax_tpu_torch.utils.tokenizer import load_tokenizer

    enable_compilation_cache(getattr(args, "compilation_cache_dir", None))
    device = resolve_device(args.device)
    config = load_config(args.model_path)
    tokenizer = load_tokenizer(args.model_path)
    model = create_stage_model(config, 0, config.num_hidden_layers)
    params = load_stage_params(model, args.model_path, device=device,
                               quantize=args.quantization,
                               lora_path=args.lora_path)

    messages = [{"role": "user", "content": args.prompt}]
    try:
        prompt_ids = tokenizer.encode(
            tokenizer.apply_chat_template(messages)
        )
    except Exception:
        prompt_ids = tokenizer.encode(args.prompt)

    max_model_len = len(prompt_ids) + args.max_tokens + 64
    page_size = 64
    engine = StageEngine(
        model, params,
        EngineConfig(
            page_size=page_size,
            num_pages=(max_model_len + page_size - 1) // page_size + 2,
            max_batch_size=1,
            max_model_len=max_model_len,
            max_num_tokens_per_batch=max(2048, len(prompt_ids)),
            kv_dtype=args.kv_dtype,
            # None/0 = adaptive multi-step decode (engine default).
            decode_lookahead=args.decode_lookahead or None,
            decode_fused=args.decode_fused,
            prefill_fused=args.prefill_fused,
        ),
        device=device,
    )
    req = Request(
        "generate",
        prompt_ids=[int(t) for t in prompt_ids],
        sampling_params=SamplingParams(
            temperature=args.temperature,
            top_k=args.top_k or -1,
            top_p=args.top_p,
            max_new_tokens=args.max_tokens,
        ),
        eos_token_ids=tuple(tokenizer.eos_token_ids),
    )
    # Single-stage engine: tokens commit locally inside the step; no
    # pipeline ring needed.
    engine.submit(req)

    decoder = IncrementalDecoder(tokenizer)
    t0 = time.perf_counter()
    ttft = None
    sent = 0
    # Overlapped two-phase loop, one step in flight: the host assembles
    # step N+1 while the device computes step N; detokenization runs one
    # step behind off the committed ids.
    pending = None
    while engine.has_work() or pending is not None:
        _, pending = drive_step(engine, pending)
        if req.output_ids and ttft is None:
            ttft = time.perf_counter() - t0
        stable = decoder.update(req.output_ids)   # cumulative stable text
        if len(stable) > sent:
            sys.stdout.write(stable[sent:])
            sys.stdout.flush()
            sent = len(stable)
    final = decoder.finalize(req.output_ids)
    sys.stdout.write(final[sent:])
    sys.stdout.write("\n")
    total = time.perf_counter() - t0

    n_out = len(req.output_ids)
    decode_s = max(total - (ttft or 0.0), 1e-9)
    logger.info(
        "%d prompt + %d generated tokens | ttft %.2fs | decode %.1f tok/s "
        "| %s",
        len(prompt_ids), n_out, ttft or 0.0,
        (n_out - 1) / decode_s if n_out > 1 else 0.0,
        req.status.value,
    )
    return 0
