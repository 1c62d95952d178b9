"""Top-k MoE layer with the reference's two dispatch strategies.

Mirrors `repro.models.moe`:
- "einsum": GShard-style capacity dispatch through one-hot einsums (the
  configs' default).  Priority is token order, then slot; an assignment
  past an expert's capacity is dropped.  The dispatch einsum runs in x's
  dtype (a 0/1 selection, exact) and the combine in f32, as plain products
  outside any kernel, as in the reference.
- "gather": per batch row, a stable argsort by expert, a gather into
  (E, C, d) buffers and a weighted sum back to the tokens; the same result
  at equal capacity.

Expert weights are stacked on a leading E axis: (E, d, f) gate and up,
(E, f, d) down.  Each expert FFN is two `blas.batched_gemm` launches over
the whole stack (`_expert_ffn`): the gate and up products as one dual-B
launch with silu, and the down product written in f32.  The router stays
f32; the shared experts run through `blas.matmul_fused`, the routed output
riding the down projection as its residual.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import blas
from repro_torch.models import layers


def init_moe(gen: torch.Generator, d: int, mcfg: MoEConfig, act: str, dtype, device) -> dict:
    """Seeded random params with the reference's distributions: router f32
    normal * d^-0.5; gate and up (E, d, f) * d^-0.5, down (E, f, d) * f^-0.5,
    generated one stack at a time on the device; the shared experts' (d, f
    * n_shared) projections likewise."""
    e, f = mcfg.num_experts, mcfg.d_ff_expert
    std = d ** -0.5
    p = {
        "router": layers._normal(gen, (d, e), std, torch.float32, device),
        "w_gate": layers._normal(gen, (e, d, f), std, dtype, device),
        "w_up": layers._normal(gen, (e, d, f), std, dtype, device),
        "w_down": layers._normal(gen, (e, f, d), f ** -0.5, dtype, device),
    }
    if mcfg.n_shared_experts:
        fs = f * mcfg.n_shared_experts
        p["shared"] = {
            "w_gate": layers._normal(gen, (d, fs), std, dtype, device),
            "w_up": layers._normal(gen, (d, fs), std, dtype, device),
            "w_down": layers._normal(gen, (fs, d), fs ** -0.5, dtype, device),
        }
    return p


def quantize_weights(params: dict, spec=None) -> dict:
    """`layers.quantize_weights` on a MoE params tree: the expert stacks keep
    the (k, n) orientation with per-expert block scales, the shared experts
    pack output-major, the router stays f32."""
    return layers.quantize_weights(params, spec)


def _expert_ffn(h, params, act: str):
    """h (E, ..., d) -> (E, ..., d): every expert's SwiGLU (GeGLU) in two
    batched launches over the expert axis, the gate half one dual-B launch
    written in h's dtype, the down projection written in f32 and then cast
    to h's dtype, as the reference does.  Packed stacks take the same two
    calls."""
    e, d = h.shape[0], h.shape[-1]
    mid_dims = h.shape[1:-1]
    h3 = h.reshape(e, -1, d).contiguous()
    activation = "silu" if act == "swiglu" else "gelu"
    mid = blas.batched_gemm(h3, params["w_gate"], B2=params["w_up"], epilogue=activation,
                            out_dtype=h.dtype)
    out = blas.batched_gemm(mid, params["w_down"], out_dtype=torch.float32)
    return out.to(h.dtype).reshape(e, *mid_dims, d)


def _route(params, x, mcfg: MoEConfig):
    """(top_w (B, T, K) f32 normalised, top_i (B, T, K), aux loss): f32
    router logits, softmax, top-k, renormalised; the Switch load-balancing
    loss E * sum_e f_e * p_e * router_aux_weight."""
    logits = torch.einsum("btd,de->bte", x.float(), params["router"])
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(gates, mcfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    e = mcfg.num_experts
    frac = F.one_hot(top_i, e).float().sum(dim=2).mean(dim=(0, 1)) / mcfg.top_k
    prob = gates.mean(dim=(0, 1))
    aux = e * torch.sum(frac * prob) * mcfg.router_aux_weight
    return top_w, top_i, aux


def _capacity(t: int, mcfg: MoEConfig) -> int:
    c = int(t * mcfg.top_k / mcfg.num_experts * mcfg.capacity_factor)
    return max(8, ((c + 3) // 4) * 4)


def _dispatch(top_w, top_i, mcfg: MoEConfig, c: int):
    """The GShard combine weights (B, T, E, C) f32: assignment (t, j) of a
    row takes its expert's next free slot in token order, then slot order,
    and is dropped once that expert's C slots are taken."""
    b, t, k = top_i.shape
    e = mcfg.num_experts
    flat = F.one_hot(top_i, e).float().reshape(b, t * k, e)
    pos = torch.cumsum(flat, dim=1) - flat                    # zero-based slot per expert
    keep = (pos < c).float() * flat                           # drop overflow
    # positions at or past c are dropped by `keep`; clamped so one_hot takes them
    slot_oh = F.one_hot(torch.clamp(pos.long(), max=c - 1), c).float() * keep[..., None]
    return (top_w.reshape(b, t * k)[:, :, None, None] * slot_oh).reshape(b, t, k, e, c).sum(2)


def moe_einsum(params: dict, x, mcfg: MoEConfig, act: str):
    """GShard capacity dispatch.  x (B, T, d) -> (y (B, T, d), aux loss)."""
    c = _capacity(x.shape[1], mcfg)
    top_w, top_i, aux = _route(params, x, mcfg)
    combine = _dispatch(top_w, top_i, mcfg, c)
    dispatch = (combine > 0).to(x.dtype)                      # (B, T, E, C)
    expert_in = torch.einsum("btec,btd->ebcd", dispatch, x)   # exact: one term a slot
    expert_out = _expert_ffn(expert_in, params, act)          # (E, B, C, d)
    y = torch.einsum("btec,ebcd->btd", combine, expert_out.float()).to(x.dtype)
    return y, aux


def moe_gather(params: dict, x, mcfg: MoEConfig, act: str):
    """Sorted dispatch, per batch row: the same result as moe_einsum at equal
    capacity.  Each row's T * K assignments are stably sorted by expert, the
    first C of each expert gathered into its (C, d) buffer (empty slots read
    a zero row), the stack run through `_expert_ffn`, and each token's K
    outputs gathered back and summed in slot order, weighted (a dropped
    assignment reads a zero row).  The reference scatter-adds instead; a
    gather keeps the sum's order fixed on the card, where index_add_ is
    atomic."""
    b, t, d = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    c = _capacity(t, mcfg)
    top_w, top_i, aux = _route(params, x, mcfg)
    dev = x.device
    arange = torch.arange(t * k, device=dev)
    ins, where = [], []
    for row in range(b):
        expert_flat = top_i[row].reshape(t * k)
        order = torch.argsort(expert_flat, stable=True)       # token priority in expert
        se, st = expert_flat[order], (arange // k)[order]
        counts = torch.bincount(expert_flat, minlength=e)
        starts = torch.cumsum(counts, 0) - counts
        rank = arange - starts[se]
        valid = rank < c
        slot = torch.where(valid, se * c + rank, torch.full_like(se, e * c))  # overflow: scratch
        buf_tok = torch.full((e * c + 1,), t, dtype=torch.long, device=dev)
        buf_tok[slot] = torch.where(valid, st, torch.full_like(st, t))
        xt_pad = torch.cat([x[row], x.new_zeros((1, d))], dim=0)
        ins.append(xt_pad[buf_tok[: e * c]].reshape(e, c, d))
        slot_of = torch.empty_like(slot)
        slot_of[order] = slot                                 # assignment -> its slot
        where.append(slot_of)
    expert_out = _expert_ffn(torch.stack(ins, dim=1), params, act)   # (E, B, C, d)
    out_rows = expert_out.movedim(0, 1).reshape(b, e * c, d)
    zero = out_rows.new_zeros((b, 1, d))
    out_pad = torch.cat([out_rows, zero], dim=1).float()              # (B, E*C + 1, d)
    y = torch.stack([
        (out_pad[row][where[row]] * top_w[row].reshape(t * k)[:, None]).reshape(t, k, d).sum(1)
        for row in range(b)])
    return y.to(x.dtype), aux


def moe_layer(params: dict, x, mcfg: MoEConfig, act: str):
    """The routed experts (mcfg.dispatch), then the shared experts' SwiGLU as
    two fused launches with the routed y as the down projection's residual.
    Returns (y, aux loss)."""
    fn = moe_gather if mcfg.dispatch == "gather" else moe_einsum
    y, aux = fn(params, x, mcfg, act)
    if mcfg.n_shared_experts:
        sp = params["shared"]
        mid = blas.matmul_fused(x, sp["w_gate"], w2=sp["w_up"], activation="silu")
        y = blas.matmul_fused(mid, sp["w_down"], residual=y)
    return y, aux
