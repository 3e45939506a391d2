"""Gated DeltaNet linear attention over per-request state slots (port of
``parallax_tpu/ops/linear_attn.py``).

State per request per linear layer, in slots of two f32 tensors:

- conv state ``[slots, conv_dim, K-1]``: the last K-1 pre-activation mixed
  q/k/v columns (the causal depthwise conv's warm-up window);
- recurrent state ``[slots, Hv, Dk, Dv]``: the delta-rule memory.

The engine's ragged step batch is densified to ``[S, maxq]`` per-sequence
steps (``BatchInputs.dense_map``); the recurrence is a loop over the
``maxq`` steps with every sequence advancing in lockstep and padding steps
leaving the state untouched. Decode batches have ``maxq = 1``, so a decode
step is one pass of the loop body, with no host sync (a window step's CUDA
graph captures it).

The JAX package computes these in XLA, outside any Pallas kernel, so the
port's versions are plain PyTorch in f32. A hand-written recurrence kernel
is port-only speed work (ROADMAP P6). The math mirrors HF's
``torch_recurrent_gated_delta_rule``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def new_linear_state(
    num_slots: int, conv_dim: int, kernel_size: int, num_v_heads: int,
    head_k_dim: int, head_v_dim: int, device="cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``(conv, recurrent)`` state of ``num_slots`` slots."""
    conv = torch.zeros((num_slots, conv_dim, kernel_size - 1),
                       dtype=torch.float32, device=device)
    rec = torch.zeros((num_slots, num_v_heads, head_k_dim, head_v_dim),
                      dtype=torch.float32, device=device)
    return conv, rec


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / sqrt(sum(x^2) + eps)`` over the last axis, in f32."""
    x = x.float()
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def causal_conv_update(
    mixed_dense: torch.Tensor,   # [S, maxq, conv_dim] pre-activation
    conv_state: torch.Tensor,    # [S, conv_dim, K-1] gathered per slot
    conv_weight: torch.Tensor,   # [conv_dim, K] depthwise taps
    seq_lens: torch.Tensor,      # i32[S] valid steps per row
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv with carried state, then silu. Padding steps
    are zeroed before the conv (they must not enter the window) and after.

    Returns ``(activated [S, maxq, conv_dim], new_conv_state [S, conv_dim,
    K-1])``: the K-1 inputs ending at each row's last valid step."""
    s, maxq, _ = mixed_dense.shape
    k = conv_weight.shape[-1]
    x = mixed_dense.float().transpose(1, 2)                 # [S, cdim, maxq]
    step = torch.arange(maxq, device=x.device)
    valid = step[None, :] < seq_lens[:, None]               # [S, maxq]
    x = torch.where(valid[:, None, :], x, 0.0)
    full = torch.cat([conv_state.float(), x], dim=-1)       # [S, c, K-1+maxq]
    # y[t] = sum_j w[j] * full[t + j]
    windows = torch.stack([full[:, :, j:j + maxq] for j in range(k)],
                          dim=-1)                           # [S, c, maxq, K]
    y = torch.einsum("sctk,ck->sct", windows, conv_weight.float())
    y = torch.where(valid[:, None, :], F.silu(y), 0.0)
    idx = seq_lens.long()[:, None] + torch.arange(k - 1, device=x.device)
    new_state = torch.gather(
        full, 2, idx[:, None, :].expand(s, full.shape[1], k - 1))
    return y.transpose(1, 2), new_state


def gated_delta_rule_scan(
    q: torch.Tensor,          # [S, maxq, Hv, Dk] (post conv, post l2norm)
    k: torch.Tensor,          # [S, maxq, Hv, Dk]
    v: torch.Tensor,          # [S, maxq, Hv, Dv]
    g: torch.Tensor,          # f32[S, maxq, Hv] log decay
    beta: torch.Tensor,       # f32[S, maxq, Hv]
    state: torch.Tensor,      # f32[S, Hv, Dk, Dv]
    seq_lens: torch.Tensor,   # i32[S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrent delta rule, one step at a time:

    state = state * exp(g_t); mem = k_t . state; delta = (v_t - mem) b_t;
    state += k_t (x) delta; out_t = q_t . state  (q pre-scaled by Dk^-0.5).

    Steps at or past a row's ``seq_len`` leave its state untouched and give
    zeros. Returns ``(out f32[S, maxq, Hv, Dv], state)``."""
    _, maxq, _, dk = q.shape
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    st = state.float()
    outs = []
    for t in range(maxq):
        valid = (seq_lens > t)
        decayed = st * torch.exp(g[:, t])[..., None, None]
        mem = torch.einsum("shkv,shk->shv", decayed, kf[:, t])
        delta = (vf[:, t] - mem) * beta[:, t][..., None]
        st_new = decayed + torch.einsum("shk,shv->shkv", kf[:, t], delta)
        out_t = torch.einsum("shkv,shk->shv", st_new, qf[:, t])
        st = torch.where(valid[:, None, None, None], st_new, st)
        outs.append(torch.where(valid[:, None, None], out_t, 0.0))
    return torch.stack(outs, dim=1), st
