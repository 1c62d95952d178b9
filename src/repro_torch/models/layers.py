"""Transformer layers of the dense family.  Every projection routes through
core.blas, every attention through the flash kernel.

Mirrors `repro.models.layers` (norms, rope, GQA attention over a dense
cache, SwiGLU MLP, embedding).  Params are plain dicts of tensors with the
reference's names and layouts: weights (d_in, d_out), cache (B, S, KVH, hd),
q/k/v (B, T, H, hd).  Unlike the reference, the KV cache is written IN
PLACE (`_cache_write`): the returned cache holds the same buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import blas, quant
from repro_torch.kernels import ops


# --------------------------------------------------------------------------
# Weight quantization pass (block-scaled int8 serving weights, core.quant)
# --------------------------------------------------------------------------

#: projection weights the serving quantization pass packs; norms, biases,
#: router logits and the embedding/unembedding tables stay as they are
QUANT_WEIGHT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def quantize_weights(params: dict, spec: Optional[quant.QuantSpec] = None) -> dict:
    """Replace every projection weight with a block-scaled int8
    `QuantizedTensor`, validated (a NaN/Inf weight raises here).

    2-D projection weights are stored output-major (`QuantSpec.transpose`),
    the layout the decode kernel streams.  Expert stacks (a dict holding a
    "router", weights with an extra expert axis) keep the GEMM orientation,
    as the reference's walk does.  Lists (the port's per-layer dicts) are
    walked element by element; a leaf already packed passes through."""
    spec = spec or quant.QuantSpec(block_m=64, block_n=None, transpose=True)

    def walk(node, in_expert: bool):
        if isinstance(node, list):
            return [walk(v, in_expert) for v in node]
        if isinstance(node, dict):
            expert = in_expert or "router" in node
            return {k: (walk(v, expert and k != "shared") if isinstance(v, (dict, list))
                        else _quantize_leaf(k, v, spec, expert and k != "shared"))
                    for k, v in node.items()}
        return node

    return walk(params, False)


def _quantize_leaf(key, leaf, spec: quant.QuantSpec, in_expert: bool):
    if key not in QUANT_WEIGHT_KEYS or not isinstance(leaf, torch.Tensor):
        return leaf
    if in_expert and leaf.ndim >= 3:
        espec = quant.QuantSpec(block_m=spec.block_m, block_n=spec.block_n, transpose=False)
        return quant.quantize(leaf, espec, validate=True)
    return quant.quantize(leaf, spec, validate=True)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(d: int, kind: str, dtype, device):
    if kind == "rms":
        return {"scale": torch.zeros(d, dtype=dtype, device=device)}  # (1 + scale) form
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def apply_norm(params: dict, x, kind: str = "rms"):
    if kind == "rms":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """x (B, T, H, hd); positions (T,) or (B, T).  Rotates the whole head
    with the half-split convention, as the reference does (it never reads
    the config's rope_pct)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.float()[..., :, None] * freqs         # (..., T, half)
    cos = torch.cos(angles)[..., :, None, :]                 # (..., T, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    use_bias: bool = False


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_attention(gen: torch.Generator, cfg: AttnConfig, dtype, device) -> dict:
    """Seeded random projections with the reference's distributions
    (normal * d^-0.5); biases start at zero, as in the reference."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    std = d ** -0.5
    p = {
        "wq": _normal(gen, (d, h * hd), std, dtype, device),
        "wk": _normal(gen, (d, kv * hd), std, dtype, device),
        "wv": _normal(gen, (d, kv * hd), std, dtype, device),
        "wo": _normal(gen, (h * hd, d), std, dtype, device),
    }
    if cfg.use_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(width, dtype=dtype, device=device)
    return p


def _cache_write(buf, new, pos) -> None:
    """Write `new` (B, T, ...) into `buf` (B, S, ...) IN PLACE at sequence
    offset `pos`: an int (every row at one offset: prefill) or a (B,) int
    tensor (each slot at its own position: the continuous-batching slot
    grid).  Offsets clamp to [0, S - T] like the reference's
    dynamic_update_slice."""
    b, t = new.shape[:2]
    s = buf.shape[1]
    if isinstance(pos, int):
        start = min(max(pos, 0), s - t)
        buf[:, start:start + t] = new
        return
    start = torch.clamp(pos.to(torch.int64), 0, s - t)
    idx = start[:, None] + torch.arange(t, device=buf.device)[None, :]
    buf[torch.arange(b, device=buf.device)[:, None], idx] = new


def _expand_kv_lens(pos, t: int, b: int, h: int, device):
    """Per-(slot, head) real KV length after this step's write: pos + t."""
    if isinstance(pos, int):
        return torch.full((b * h,), pos + t, dtype=torch.int32, device=device)
    return (pos.to(torch.int32) + t)[:, None].expand(b, h).reshape(b * h).contiguous()


def attention_layer(params: dict, x, cfg: AttnConfig, *, positions,
                    cache: Optional[dict] = None, residual=None):
    """Returns (out, new_cache).  With a cache {"k", "v": (B, S, KVH, hd),
    "pos": int | (B,)}, x is the new-token block appended at pos (each slot
    at its own position for a (B,) pos); the write is in place and
    new_cache["pos"] is pos + T.  `residual` is added in the output
    projection's epilogue, so `out` already includes it."""
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    if cfg.use_bias:
        q = blas.matmul_fused(x, params["wq"], bias=params["bq"])
        k = blas.matmul_fused(x, params["wk"], bias=params["bk"])
        v = blas.matmul_fused(x, params["wv"], bias=params["bv"])
    else:
        q = blas.matmul(x, params["wq"])
        k = blas.matmul(x, params["wk"])
        v = blas.matmul(x, params["wv"])
    q = rope(q.reshape(b, t, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, t, kv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, t, kv, hd)

    new_cache = None
    if cache is not None:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        _cache_write(ck, k.to(ck.dtype), pos)
        _cache_write(cv, v.to(cv.dtype), pos)
        new_cache = {"k": ck, "v": cv, "pos": pos + t}
        lens = _expand_kv_lens(pos, t, b, h, x.device)
    else:
        ck, cv = k, v
        lens = torch.full((b * h,), t, dtype=torch.int32, device=x.device)
    out = ops.flash_attention(q, ck, cv, kv_lens=lens, kv_groups=h // kv)
    out = blas.matmul_fused(out.reshape(b, t, h * hd), params["wo"], residual=residual)
    return out, new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, kind: str, dtype, device) -> dict:
    if kind not in ("swiglu", "geglu"):
        raise NotImplementedError(f"mlp kind {kind!r} is not ported (ROADMAP §1)")
    return {
        "w_gate": _normal(gen, (d, d_ff), d ** -0.5, dtype, device),
        "w_up": _normal(gen, (d, d_ff), d ** -0.5, dtype, device),
        "w_down": _normal(gen, (d_ff, d), d_ff ** -0.5, dtype, device),
    }


def mlp(params: dict, x, kind: str = "swiglu", residual=None):
    """Gated MLP: act(x @ w_gate) * (x @ w_up) is ONE dual-GEMM launch, and
    the down projection carries the block residual."""
    if kind not in ("swiglu", "geglu"):
        raise NotImplementedError(f"mlp kind {kind!r} is not ported (ROADMAP §1)")
    act = "silu" if kind == "swiglu" else "gelu"
    mid = blas.matmul_fused(x, params["w_gate"], w2=params["w_up"], activation=act)
    return blas.matmul_fused(mid, params["w_down"], residual=residual)


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype, device) -> dict:
    return {"table": _normal(gen, (vocab, d), d ** -0.5, dtype, device)}


def embed(params: dict, tokens, scale: bool = False):
    out = params["table"][tokens]
    if scale:
        out = out * torch.tensor(math.sqrt(out.shape[-1]), dtype=out.dtype)
    return out
