"""Tensor ops of the port: plain PyTorch functions, and the wrappers of the
hand-written CUDA kernels (which build on first launch, never at import)."""

from parallax_tpu_torch.ops.kv_cache_ops import (
    interleave_kv,
    new_kv_pages,
    reshape_and_cache,
)
from parallax_tpu_torch.ops.rope import apply_rope, apply_rope_interleaved

__all__ = [
    "apply_rope",
    "apply_rope_interleaved",
    "interleave_kv",
    "new_kv_pages",
    "reshape_and_cache",
]
