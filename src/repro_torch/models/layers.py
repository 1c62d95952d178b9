"""Transformer layers.  Every projection routes through core.blas, every
attention through the flash kernel.

Mirrors `repro.models.layers` (norms, rope, GQA attention over a dense or
paged KV cache in the model dtype or int8 under the causal, prefix-LM or
non-causal mask, cache-less attention (`attention_dispatch`: whisper's
cross-attention), the SwiGLU, GeGLU and plain (biased) gelu MLPs,
embedding).  Params are plain dicts of tensors with the reference's names
and layouts: weights (d_in, d_out), cache (B, S, KVH, hd) or a page pool
(num_pages, page_size, KVH, hd), q/k/v (B, T, H, hd).  Unlike the
reference, the KV cache is written IN PLACE (`_cache_write`,
`_paged_cache_write`): the returned cache holds the same buffers.
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
    causal: bool = True
    use_rope: bool = True


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


def _cache_write_kv(bufs: tuple, qt: quant.QuantizedTensor, pos) -> None:
    """Write a freshly quantized K or V block (quant.quantize_kv of the new
    (B, T, H, hd) block) into the int8 value buffer and its f32 scale buffer
    (B, S, H, 1) IN PLACE, at the same offsets: a value row never lands
    without its scale."""
    vbuf, sbuf = bufs
    _cache_write(vbuf, qt.values, pos)
    _cache_write(sbuf, qt.scales, pos)


def _paged_write_coords(page_table, pos, t: int, page_size: int) -> tuple:
    """(pages, offs) flat scatter coordinates (B*T,) for writing a (B, T)
    token block through the page table: token (b, i) at logical position
    pos_b + i lands in pool page page_table[b, (pos_b + i) // page_size] at
    row (pos_b + i) % page_size.  An int pos broadcasts (prefill), a (B,)
    pos is the ragged slot grid.  The page index is clipped to the table
    (the reference's mode="clip"), so even an at-capacity frozen slot
    writes in bounds; dead entries point at the trash page."""
    b, max_pages = page_table.shape
    steps = torch.arange(t, device=page_table.device)
    if isinstance(pos, int):
        posk = (steps + pos)[None, :].expand(b, t)
    else:
        posk = pos.to(torch.int64)[:, None] + steps[None, :]
    idx = torch.clamp(posk // page_size, 0, max_pages - 1)
    pages = torch.gather(page_table.to(torch.int64), 1, idx)
    return pages.reshape(-1), (posk % page_size).reshape(-1)


def _paged_cache_write(buf, new, pages, offs) -> None:
    """Scatter `new` (B, T, H, ...) into the page pool `buf`
    (num_pages, page_size, H, ...) IN PLACE at the flat (pages, offs)
    coordinates."""
    buf[pages, offs] = new.reshape((-1,) + tuple(new.shape[2:])).to(buf.dtype)


def _paged_cache_write_kv(bufs: tuple, qt: quant.QuantizedTensor, pages, offs) -> None:
    """Paged `_cache_write_kv`: int8 values and their scales scatter through
    the same page-table coordinates."""
    vbuf, sbuf = bufs
    _paged_cache_write(vbuf, qt.values, pages, offs)
    _paged_cache_write(sbuf, qt.scales, pages, offs)


def _expand_kv_lens(pos, t: int, b: int, h: int, device):
    """Per-(slot, head) real KV length after this step's write: pos + t."""
    if isinstance(pos, int):
        return torch.full((b * h,), pos + t, dtype=torch.int32, device=device)
    return (pos.to(torch.int32) + t)[:, None].expand(b, h).reshape(b * h).contiguous()


def attention_dispatch(q, k, v, *, causal: bool = True, prefix_len=None, groups: int = 1):
    """Attention of cache-less operands, q (B, Tq, H, hd) over k/v (B, Tk,
    KVH, hd) with groups = H // KVH, every row seeing all Tk keys (query t
    at position t + Tk - Tq): the reference's `attention_dispatch` without a
    q_offset, as whisper's cross-attention calls it (causal=False, the
    encoder's K/V un-expanded)."""
    b, tq, h, _ = q.shape
    lens = torch.full((b * h,), k.shape[1], dtype=torch.int32, device=q.device)
    return ops.flash_attention(q, k, v, kv_lens=lens, kv_groups=groups, causal=causal,
                               prefix_len=prefix_len)


def attention_layer(params: dict, x, cfg: AttnConfig, *, positions,
                    cache: Optional[dict] = None, prefix_len=None, residual=None):
    """Returns (out, new_cache).  With a cache {"k", "v", "pos": int | (B,)},
    x is the new-token block appended at pos (each slot at its own position
    for a (B,) pos); writes are in place and new_cache["pos"] is pos + T.
    The cache is one of three forms, as in the reference:

    - paged: "page_table" (B, max_pages) int32 and k/v the page pool
      (num_pages, page_size, KVH, hd); int8 pools carry "k_scale"/"v_scale"
      (num_pages, page_size, KVH, 1) f32 beside them;
    - dense int8: k/v (B, S, KVH, hd) int8 with "k_scale"/"v_scale";
    - dense in the model dtype: k/v (B, S, KVH, hd).

    The roped (cfg.use_rope), un-expanded (B, T, KVH, hd) K/V blocks reach
    the write; int8 caches quantize them per (token, head) first.  The mask
    is cfg.causal's, with prefix_len's prefix-LM relaxation.  `residual` is
    added in the output projection's epilogue, so `out` already includes
    it."""
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
    q, k, v = q.reshape(b, t, h, hd), k.reshape(b, t, kv, hd), v.reshape(b, t, kv, hd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    scales = {}
    page_table = None
    if cache is not None:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        int8 = ck.dtype == torch.int8
        if int8:
            kq, vq = quant.quantize_kv(k), quant.quantize_kv(v)
            scales = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}
        page_table = cache.get("page_table")
        if page_table is not None:
            pages, offs = _paged_write_coords(page_table, pos, t, ck.shape[1])
            if int8:
                _paged_cache_write_kv((ck, scales["k_scale"]), kq, pages, offs)
                _paged_cache_write_kv((cv, scales["v_scale"]), vq, pages, offs)
            else:
                _paged_cache_write(ck, k, pages, offs)
                _paged_cache_write(cv, v, pages, offs)
        elif int8:
            _cache_write_kv((ck, scales["k_scale"]), kq, pos)
            _cache_write_kv((cv, scales["v_scale"]), vq, pos)
        else:
            _cache_write(ck, k.to(ck.dtype), pos)
            _cache_write(cv, v.to(cv.dtype), pos)
        new_cache = {"k": ck, "v": cv, **scales, "pos": pos + t}
        lens = _expand_kv_lens(pos, t, b, h, x.device)
    else:
        ck, cv = k, v
        lens = torch.full((b * h,), t, dtype=torch.int32, device=x.device)
    out = ops.flash_attention(q, ck, cv, kv_lens=lens, kv_groups=h // kv,
                              k_scales=scales.get("k_scale"),
                              v_scales=scales.get("v_scale"), page_table=page_table,
                              causal=cfg.causal, prefix_len=prefix_len)
    out = blas.matmul_fused(out.reshape(b, t, h * hd), params["wo"], residual=residual)
    return out, new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, kind: str, dtype, device,
             use_bias: bool = False) -> dict:
    """Seeded random weights; the plain gelu MLP also gets zero biases
    "b_up"/"b_down" when use_bias (whisper), as in the reference."""
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": _normal(gen, (d, d_ff), d ** -0.5, dtype, device),
            "w_up": _normal(gen, (d, d_ff), d ** -0.5, dtype, device),
            "w_down": _normal(gen, (d_ff, d), d_ff ** -0.5, dtype, device),
        }
    if kind != "gelu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported (ROADMAP §1)")
    p = {"w_up": _normal(gen, (d, d_ff), d ** -0.5, dtype, device),
         "w_down": _normal(gen, (d_ff, d), d_ff ** -0.5, dtype, device)}
    if use_bias:
        p["b_up"] = torch.zeros(d_ff, dtype=dtype, device=device)
        p["b_down"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def mlp(params: dict, x, kind: str = "swiglu", residual=None):
    """Gated MLP: act(x @ w_gate) * (x @ w_up) is ONE dual-GEMM launch, and
    the down projection carries the block residual.  The plain two-matrix
    "gelu" MLP fuses bias + gelu into the up projection and bias + residual
    into the down projection."""
    if kind in ("swiglu", "geglu"):
        act = "silu" if kind == "swiglu" else "gelu"
        mid = blas.matmul_fused(x, params["w_gate"], w2=params["w_up"], activation=act)
        return blas.matmul_fused(mid, params["w_down"], residual=residual)
    if kind != "gelu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported (ROADMAP §1)")
    hdn = blas.matmul_fused(x, params["w_up"], bias=params.get("b_up"), activation="gelu")
    return blas.matmul_fused(hdn, params["w_down"], bias=params.get("b_down"),
                             residual=residual)


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
