"""Mamba2 SSD blocks of the Zamba2 hybrid.

Mirrors `repro.models.mamba` in the reference's op order and dtypes: the
in-projection splits into the gate z, the conv input xBC and dt; a
depthwise causal conv (K taps, rounded op by op in the model dtype, as the
reference's bf16 conv is); f32 softplus dt and log-decay; the SSD over
(B*NH, T, P) heads with B and C shared by the heads of a group; the D skip
on the dt-scaled input; the gated rms norm and the out-projection, with the
residual added after it.  Both projections go through `core.blas.matmul`
(bgemv for a (B, 1, d) decode step, bgemm for a (B, T, d) prefill); a
prefill's SSD is one launch of the chunked kernel (`kernels.ops.mamba2_ssd`),
and a decode step's single-token recurrence (`ssd_step`) is plain PyTorch,
as in the reference.

State per block: {"conv": (B, K-1, d_xbc) in the model dtype,
"h": (B, NH, N, P) f32}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import blas
from repro_torch.kernels import ops
from repro_torch.models import layers


def ssd_chunked(x, a_log, b, c, h0=None, chunk: int = 64):
    """x (BH, T, P), a_log (BH, T), b/c (BH, T, N) -> (y (BH, T, P) in x's
    dtype, h (BH, N, P) f32): one launch of the chunked kernel.  The
    operands are made contiguous here: a head split of a batch-1 (1, T, d)
    activation can come back as a strided view."""
    return ops.mamba2_ssd(x.contiguous(), a_log.float().contiguous(), b.contiguous(),
                          c.contiguous(), h0=None if h0 is None else h0.float().contiguous(),
                          chunk=chunk)


def ssd_step(x, a_log, b, c, h):
    """Single token: x (BH, P), a_log (BH,), b/c (BH, N), h (BH, N, P)."""
    xf, bf, cf = (z.float() for z in (x, b, c))
    h = torch.exp(a_log.float())[:, None, None] * h + bf[:, :, None] * xf[:, None, :]
    y = torch.einsum("bn,bnp->bp", cf, h)
    return y.to(x.dtype), h


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expansion * cfg.d_model
    nh = d_in // s.head_dim
    d_xbc = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, d_xbc


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Seeded random params with the reference's distributions; a_log,
    dt_bias and d_skip are f32 leaves in any model dtype."""
    s, d_in, nh, d_xbc = _dims(cfg)
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": layers.init_norm(d, "rms", dtype, device),
        "in_proj": layers._normal(gen, (d, d_in + d_xbc + nh), d ** -0.5, dtype, device),
        "conv_w": layers._normal(gen, (s.conv_kernel, d_xbc), 0.2, dtype, device),
        "conv_b": torch.zeros(d_xbc, dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros(nh, **f32),
        "d_skip": torch.ones(nh, **f32),
        "gate_norm": layers.init_norm(d_in, "rms", dtype, device),
        "out_proj": layers._normal(gen, (d_in, d), d_in ** -0.5, dtype, device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv1d.  x (B, T, C), w (K, C).  Returns (y,
    new_state).  Every product and add is its own op in x's dtype, as the
    reference computes it; one f32 sum would round differently in bf16."""
    k = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    return y, xp[:, -(k - 1):, :]


def mamba_block(params, x, cfg: ModelConfig, state=None):
    """x (B, T, d).  state {"conv": (B, K-1, d_xbc), "h": (B, NH, N, P)} or
    None (zeros).  Returns (x + out, new_state)."""
    s, d_in, nh, d_xbc = _dims(cfg)
    b_, t, _ = x.shape
    g, n, p = s.n_groups, s.d_state, s.head_dim

    h_in = layers.apply_norm(params["norm"], x, "rms")
    zxbcdt = blas.matmul(h_in, params["in_proj"])
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_xbc, nh], dim=-1)

    conv_state = state["conv"] if state is not None else None
    xbc, conv_new = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xin, bmat, cmat = torch.split(xbc, [d_in, g * n, g * n], dim=-1)

    dt_in = dt_raw.float() + params["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))           # softplus, (B, T, NH)
    a_log = -torch.exp(params["a_log"])[None, None, :] * dt          # <= 0

    # head layout: (B, T, NH, P) -> (B*NH, T, P); B/C shared across heads per group
    xh = xin.reshape(b_, t, nh, p).transpose(1, 2).reshape(b_ * nh, t, p)
    xh = xh * dt.transpose(1, 2).reshape(b_ * nh, t)[..., None].to(xh.dtype)
    heads_per_g = nh // g

    def expand(m):
        return m.reshape(b_, t, g, 1, n).expand(b_, t, g, heads_per_g, n).reshape(
            b_, t, nh, n).transpose(1, 2).reshape(b_ * nh, t, n)

    bh_, ch_ = expand(bmat), expand(cmat)
    ah = a_log.transpose(1, 2).reshape(b_ * nh, t)

    h0 = state["h"].reshape(b_ * nh, n, p).float() if state is not None else None
    if t == 1 and state is not None:
        y, h_fin = ssd_step(xh[:, 0], ah[:, 0], bh_[:, 0], ch_[:, 0], h0)
        y = y[:, None, :]
    else:
        y, h_fin = ssd_chunked(xh, ah, bh_, ch_, h0=h0, chunk=s.chunk)

    y = y.reshape(b_, nh, t, p).transpose(1, 2)                       # (B, T, NH, P)
    # the D skip multiplies the dt-scaled input, as the reference does
    y = y + params["d_skip"][None, None, :, None].to(y.dtype) * xh.reshape(
        b_, nh, t, p).transpose(1, 2)
    y = y.reshape(b_, t, d_in)
    y = layers.rms_norm((y.float() * F.silu(z.float())).to(x.dtype),
                        params["gate_norm"]["scale"])
    out = blas.matmul(y, params["out_proj"])
    new_state = {"conv": conv_new, "h": h_fin.reshape(b_, nh, n, p)}
    return x + out, new_state
