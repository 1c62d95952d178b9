"""RWKV6 "Finch" blocks (attention-free, data-dependent decay).

Mirrors `repro.models.rwkv`: token-shift mixing with static per-channel
coefficients, a per-channel data-dependent decay from a low-rank MLP, the
bonus `u` for the current token, a per-head group norm and a squared-ReLU
channel mix, in the reference's op order and dtypes.  Every projection goes
through `core.blas.matmul` (bgemv for a (B, 1, d) decode step, bgemm for a
(B, T, d) prefill); a prefill's WKV recurrence is one launch of the chunked
kernel (`kernels.ops.rwkv6`), and a decode step's single-token recurrence
(`wkv6_step`) is plain PyTorch, as in the reference.

State per block: {"tm": {"x_prev": (B, d), "s": (B, H, hd, hd) f32},
"cm": {"x_prev": (B, d)}}.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import blas
from repro_torch.kernels import ops
from repro_torch.models import layers


def wkv6_chunked(r, k, v, w_log, u, s0=None, chunk: int = 32):
    """r/k/w_log (BH, T, K), v (BH, T, V), u (BH, K) -> (y (BH, T, V) in
    r's dtype, s (BH, K, V) f32): one launch of the chunked kernel.  The
    operands are made contiguous here: a head split of a batch-1 (1, T, d)
    activation can come back as a strided view."""
    return ops.rwkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                     w_log.float().contiguous(), u.float().contiguous(),
                     s0=None if s0 is None else s0.float().contiguous(), chunk=chunk)


def wkv6_step(r, k, v, w_log, u, s):
    """Single-token recurrence.  r/k/w (BH, K), v (BH, V), s (BH, K, V)."""
    rf, kf, vf = (z.float() for z in (r, k, v))
    kv = kf[:, :, None] * vf[:, None, :]
    y = torch.einsum("bk,bkv->bv", rf, s + u.float()[:, :, None] * kv)
    s = torch.exp(w_log.float())[:, :, None] * s + kv
    return y.to(r.dtype), s


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def init_time_mix(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Seeded random params with the reference's distributions; decay_w0 and
    u are f32 leaves in any model dtype."""
    d = cfg.d_model
    rank = cfg.rwkv.decay_lora_rank
    hd = cfg.rwkv.head_dim
    nh = d // hd
    std = d ** -0.5
    p = {"mu": torch.full((5, d), 0.5, dtype=dtype, device=device)}  # r, k, v, w, g
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = layers._normal(gen, (d, d), std, dtype, device)
    p["decay_w0"] = torch.full((d,), -6.0, dtype=torch.float32, device=device)
    p["decay_a"] = layers._normal(gen, (d, rank), std, dtype, device)
    p["decay_b"] = layers._normal(gen, (rank, d), rank ** -0.5, dtype, device)
    p["u"] = layers._normal(gen, (nh, hd), 0.1, torch.float32, device)
    p["ln_x"] = torch.ones(d, dtype=dtype, device=device)
    return p


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    std = d ** -0.5
    return {"mu": torch.full((2, d), 0.5, dtype=dtype, device=device),  # r, k
            "w_r": layers._normal(gen, (d, d), std, dtype, device),
            "w_k": layers._normal(gen, (d, f), std, dtype, device),
            "w_v": layers._normal(gen, (f, d), f ** -0.5, dtype, device)}


def _token_shift(x, x_prev):
    """x (B, T, d) shifted right by one token; the first row is x_prev (B, d)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def time_mix(params, x, cfg: ModelConfig, state=None):
    """x (B, T, d).  state: {"x_prev": (B, d), "s": (B, H, K, V)} or None
    (zeros).  Returns (out, new_state)."""
    b, t, d = x.shape
    hd = cfg.rwkv.head_dim
    nh = d // hd
    x_prev = state["x_prev"] if state is not None else torch.zeros(
        (b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))

    r = blas.matmul(xr, params["w_r"])
    k = blas.matmul(xk, params["w_k"])
    v = blas.matmul(xv, params["w_v"])
    g = torch.nn.functional.silu(blas.matmul(xg, params["w_g"]).float()).to(x.dtype)
    # data-dependent decay (the Finch feature): w = -exp(w0 + tanh(xw A) B)
    lora = blas.matmul(torch.tanh(blas.matmul(xw, params["decay_a"]).float()).to(x.dtype),
                       params["decay_b"])
    w_log = -torch.exp(params["decay_w0"] + lora.float())  # (B, T, d) <= 0
    w_log = torch.clamp(w_log, min=-20.0)

    def to_h(z):  # (B, T, d) -> (B*H, T, hd)
        return z.reshape(b, t, nh, hd).transpose(1, 2).reshape(b * nh, t, hd)

    u = params["u"][None].expand(b, nh, hd).reshape(b * nh, hd)
    s0 = state["s"].reshape(b * nh, hd, hd).float() if state is not None else None

    if t == 1 and state is not None:
        # the decode step rounds w_log to the model dtype first, as the
        # reference does (prefill passes it in f32)
        y, s_fin = wkv6_step(to_h(r)[:, 0], to_h(k)[:, 0], to_h(v)[:, 0],
                             to_h(w_log.to(x.dtype))[:, 0].float(), u, s0)
        y = y[:, None, :]
    else:
        y, s_fin = wkv6_chunked(to_h(r), to_h(k), to_h(v), to_h(w_log.float()), u,
                                s0=s0, chunk=cfg.rwkv.chunk)
    y = y.reshape(b, nh, t, hd).transpose(1, 2)  # (B, T, H, hd)
    y = layers.rms_norm(y, params["ln_x"].reshape(nh, hd) - 1.0)  # per-head norm
    y = (y.reshape(b, t, d).float() * g.float()).to(x.dtype)
    out = blas.matmul(y, params["w_o"])
    new_state = {"x_prev": x[:, -1, :], "s": s_fin.reshape(b, nh, hd, hd)}
    return out, new_state


def channel_mix(params, x, state=None):
    b, t, d = x.shape
    x_prev = state["x_prev"] if state is not None else torch.zeros(
        (b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_prev)
    mu = params["mu"]
    xr = x + (xs - x) * mu[0]
    xk = x + (xs - x) * mu[1]
    k = blas.matmul(xk, params["w_k"]).float()
    k = torch.square(torch.relu(k)).to(x.dtype)
    out = torch.sigmoid(blas.matmul(xr, params["w_r"]).float()).to(x.dtype) * blas.matmul(
        k, params["w_v"])
    return out, {"x_prev": x[:, -1, :]}


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    return {"ln1": layers.init_norm(cfg.d_model, "ln", dtype, device),
            "ln2": layers.init_norm(cfg.d_model, "ln", dtype, device),
            "tm": init_time_mix(gen, cfg, dtype, device),
            "cm": init_channel_mix(gen, cfg, dtype, device)}


def rwkv_block(params, x, cfg: ModelConfig, state=None):
    """Returns (x, new_state).  The two residual adds stay separate ops, as
    in the reference (an epilogue add would round differently)."""
    tm_state = state["tm"] if state is not None else None
    cm_state = state["cm"] if state is not None else None
    h, tm_new = time_mix(params["tm"], layers.apply_norm(params["ln1"], x, "ln"), cfg, tm_state)
    x = x + h
    h, cm_new = channel_mix(params["cm"], layers.apply_norm(params["ln2"], x, "ln"), cm_state)
    x = x + h
    return x, {"tm": tm_new, "cm": cm_new}
