"""Rotary position embeddings, applied per token by absolute position
(port of ``parallax_tpu/ops/rope.py``).

Supports NeoX-style rotate-half, GPT-J interleaved pairs, partial rotary
dims, linear/dynamic-NTK scaling, and Llama-3 / YaRN frequency correction.
Tables are float32; rotation runs in float32 and casts back.
"""

from __future__ import annotations

import math

import torch


def rope_frequencies(
    head_dim: int,
    rope_theta: float,
    rope_scaling: dict | None = None,
    partial_rotary_factor: float = 1.0,
    device=None,
) -> torch.Tensor:
    """Per-dimension inverse frequencies (f32), with HF rope_scaling applied."""
    rot_dim = int(head_dim * partial_rotary_factor)
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    inv_freq = 1.0 / (
        torch.tensor(rope_theta, dtype=torch.float32, device=device) ** exps
    )
    if not rope_scaling:
        return inv_freq
    rtype = rope_scaling.get("rope_type") or rope_scaling.get("type") or "default"
    factor = float(rope_scaling.get("factor", 1.0))
    if rtype in ("linear", "dynamic"):
        inv_freq = inv_freq / factor
    elif rtype == "llama3":
        low = float(rope_scaling.get("low_freq_factor", 1.0))
        high = float(rope_scaling.get("high_freq_factor", 4.0))
        orig = float(rope_scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        ratio = orig / wavelen
        smooth = torch.clamp((ratio - low) / (high - low), 0.0, 1.0)
        mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < orig / high,
            inv_freq,
            torch.where(wavelen > orig / low, inv_freq / factor, mid),
        )
    elif rtype == "yarn":
        orig = float(rope_scaling.get("original_max_position_embeddings", 4096))
        beta_fast = float(rope_scaling.get("beta_fast", 32.0))
        beta_slow = float(rope_scaling.get("beta_slow", 1.0))

        def correction_dim(num_rotations: float) -> float:
            return (
                rot_dim
                * math.log(orig / (num_rotations * 2.0 * math.pi))
                / (2.0 * math.log(rope_theta))
            )

        low = max(math.floor(correction_dim(beta_fast)), 0)
        high = min(math.ceil(correction_dim(beta_slow)), rot_dim // 2 - 1)
        ramp = torch.clamp(
            (torch.arange(rot_dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 1e-3),
            0.0, 1.0,
        )
        extrapolation_factor = 1.0 - ramp
        inv_freq = (
            inv_freq / factor * (1.0 - extrapolation_factor)
            + inv_freq * extrapolation_factor
        )
    return inv_freq


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN attention magnitude correction (DeepSeek convention)."""
    if scale <= 1.0 or mscale == 0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_table(
    inv_freq: torch.Tensor, max_positions: int, attention_scaling: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin) tables of shape [max_positions, rot_dim/2]."""
    pos = torch.arange(max_positions, dtype=torch.float32, device=inv_freq.device)
    freqs = torch.outer(pos, inv_freq)
    return torch.cos(freqs) * attention_scaling, torch.sin(freqs) * attention_scaling


def _rope(x, positions, cos_table, sin_table, interleaved: bool):
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None, :]
    t, h, d = x.shape
    rot = cos_table.shape[-1] * 2
    pos = positions.long()
    cos = cos_table[pos][:, None, :]  # [T, 1, rot/2]
    sin = sin_table[pos][:, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    if interleaved:
        x1 = x_rot[..., 0::2].float()
        x2 = x_rot[..., 1::2].float()
        out = torch.stack(
            [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
        ).reshape(t, h, rot)
    else:
        x1 = x_rot[..., : rot // 2].float()
        x2 = x_rot[..., rot // 2 :].float()
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    if d > rot:
        out = torch.cat([out, x_pass], dim=-1)
    if squeeze:
        out = out[:, 0, :]
    return out


def apply_rope(x, positions, cos_table, sin_table) -> torch.Tensor:
    """Rotate queries/keys ``x [T, H, D]`` (or ``[T, D]``) by their absolute
    ``positions`` (NeoX halves convention)."""
    return _rope(x, positions, cos_table, sin_table, interleaved=False)


def apply_rope_interleaved(x, positions, cos_table, sin_table) -> torch.Tensor:
    """GPT-J/GLM-style interleaved rotary: adjacent dim pairs rotate
    together."""
    return _rope(x, positions, cos_table, sin_table, interleaved=True)
