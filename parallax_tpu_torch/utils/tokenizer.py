"""Tokenizer loading (a copy of ``parallax_tpu/utils/tokenizer.py``).

The HF tokenizer when the checkpoint has tokenizer files and
``transformers`` imports (imported only then), else the byte-level
fallback with a warning. Free of frontend imports, so a worker without the
HTTP plane can load it too.
"""

from __future__ import annotations

import os

from parallax_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class SimpleTokenizer:
    """Byte-level fallback tokenizer for checkpoints without tokenizer files."""

    vocab_size = 256 + 2
    bos_id = 256
    eos_id = 257

    def encode(self, text: str) -> list[int]:
        if not text:
            return []
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    @property
    def eos_token_ids(self):
        return (self.eos_id,)

    def apply_chat_template(self, messages) -> str:
        return "\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\nassistant:"

    def vocab_bytes(self) -> list[bytes]:
        """Exact token->bytes map for grammar-constrained decoding (the
        generic decode() fallback would mangle non-ASCII lead bytes)."""
        return [bytes([i]) for i in range(256)] + [b"", b""]


def load_tokenizer(model_path: str | None):
    if model_path:
        try:
            if not any(
                os.path.exists(os.path.join(model_path, f))
                for f in ("tokenizer.json", "tokenizer_config.json",
                          "tokenizer.model")
            ):
                raise FileNotFoundError("no tokenizer files in checkpoint")
            from transformers import AutoTokenizer

            # local_files_only: never hit the hub (serving hosts may be
            # air-gapped; a hub fetch can hang for minutes).
            tok = AutoTokenizer.from_pretrained(
                model_path, local_files_only=True
            )

            class _HF:
                vocab_size = tok.vocab_size

                def encode(self, text):
                    return tok.encode(text)

                def decode(self, ids):
                    return tok.decode(ids, skip_special_tokens=True)

                @property
                def eos_token_ids(self):
                    return (tok.eos_token_id,) if tok.eos_token_id else ()

                def get_vocab(self):
                    return tok.get_vocab()

                @property
                def all_special_ids(self):
                    return getattr(tok, "all_special_ids", None) or ()

                def get_added_vocab(self):
                    return getattr(tok, "get_added_vocab", dict)() or {}

                def apply_chat_template(self, messages):
                    return tok.apply_chat_template(
                        messages, tokenize=False, add_generation_prompt=True
                    )

            return _HF()
        except Exception as e:
            logger.warning("tokenizer load failed (%s); using byte fallback", e)
    return SimpleTokenizer()
