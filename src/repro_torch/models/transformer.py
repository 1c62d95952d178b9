"""Dense-family model assembly: params, forward, KV cache, prefill, decode.

Mirrors `repro.models.transformer` for the dense family.  Params are a dict
with the reference's leaf names; where the reference stacks layers along a
leading axis for `lax.scan`, the port keeps a Python list of per-layer dicts
and loops over it.  The cache keeps the reference layout, (L, B, S, KVH, hd)
per K and V, and is updated IN PLACE: every function that takes a cache
returns a dict over the same buffers.

Public API:
    init_params(cfg, seed, device)        -> params
    init_cache(cfg, batch, max_len, ...)  -> cache
    forward(params, tokens, cfg, cache)   -> (hidden (B, T, d), cache)
    prefill(params, tokens, cache, cfg)   -> (last-position logits (B, V), cache)
    decode_step(params, token, cache, cfg)-> (logits (B, V), cache)
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import AttnConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for config options this slice of the port does not run."""
    unported = {
        "family": cfg.family != "dense",
        "qk_norm": cfg.qk_norm,
        "parallel_block": cfg.parallel_block,
        "kv_cache_dtype": cfg.kv_cache_dtype != "model",
        "weight_dtype": cfg.weight_dtype != "model",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.arch_id}: {bad} not ported yet (ROADMAP §1)")


def _attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                      head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                      use_bias=cfg.use_bias)


def dense_block(params, x, cfg: ModelConfig, *, positions, cache=None):
    """Returns (x, new_cache).  Both skip connections ride the fused
    epilogues of the wo and w_down projections."""
    a, new_cache = layers.attention_layer(
        params["attn"], layers.apply_norm(params["ln1"], x, cfg.norm),
        _attn_cfg(cfg), positions=positions, cache=cache, residual=x)
    h = layers.apply_norm(params["ln2"], a, cfg.norm)
    return layers.mlp(params["ffn"], h, cfg.act, residual=a), new_cache


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random params on `device`, with the distributions of the
    reference's init_params (normal * fan_in^-0.5 weights, zero biases,
    unit norms).  torch's generator gives other numbers than jax.random
    from the same seed: tests hand both packages one set of params through
    models.convert instead."""
    check_supported(cfg)
    device = torch.device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = cfg.d_model
    params = {"embed": layers.init_embedding(gen, cfg.vocab, d, dtype, device),
              "final_norm": layers.init_norm(d, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = {"w": layers._normal(gen, (d, cfg.vocab), d ** -0.5, dtype, device)}
    params["layers"] = [
        {"ln1": layers.init_norm(d, cfg.norm, dtype, device),
         "attn": layers.init_attention(gen, _attn_cfg(cfg), dtype, device),
         "ffn": layers.init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device),
         "ln2": layers.init_norm(d, cfg.norm, dtype, device)}
        for _ in range(cfg.n_layers)
    ]
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def forward(params, tokens, cfg: ModelConfig, cache=None):
    """tokens (B, T) int.  Returns (final-normed hidden (B, T, d), cache)."""
    b, t = tokens.shape
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    pos = cache["pos"] if cache is not None else 0
    steps = torch.arange(t, device=tokens.device)
    if isinstance(pos, int):
        positions = steps + pos
    else:
        # per-slot serving cache: each slot at its own ragged position
        positions = pos.to(torch.int64)[:, None] + steps[None, :]
    for i, lp in enumerate(params["layers"]):
        lc = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        x, _ = dense_block(lp, x, cfg, positions=positions, cache=lc)
    new_cache = None if cache is None else {"k": cache["k"], "v": cache["v"], "pos": pos + t}
    return layers.apply_norm(params["final_norm"], x, cfg.norm), new_cache


def _logits_chunk(params, x, cfg: ModelConfig):
    """LM head in f32: products of the stored values summed in f32, as the
    reference's einsum with preferred_element_type=f32.  A plain matmul
    outside any kernel, as in the reference."""
    w = params["embed"]["table"].t() if cfg.tie_embeddings else params["head"]["w"]
    logits = torch.matmul(x.float(), w.float())
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, per_slot: bool = False,
               device="cuda") -> dict:
    """Zeroed dense KV cache.  per_slot=True gives a (batch,) int32 "pos"
    (continuous batching: every slot at its own position); otherwise "pos"
    is a Python int shared by every row."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device) if per_slot else 0,
    }


def insert_slots_cache(cache: dict, mini: dict, slots) -> dict:
    """Graft rows of a freshly prefilled scalar-pos cache into serving slots,
    IN PLACE.  Row i of `mini` replaces slot slots[i] wholesale and sets that
    slot's pos to mini's pos; slots[i] < 0 marks a padding row, dropped."""
    slots = torch.as_tensor(slots, dtype=torch.int64)
    rows = torch.nonzero(slots >= 0).flatten()
    dst = slots[rows].to(cache["k"].device)
    rows = rows.to(cache["k"].device)
    for key in ("k", "v"):
        cache[key][:, dst] = mini[key][:, rows].to(cache[key].dtype)
    cache["pos"][dst] = mini["pos"]
    return cache


def prefill(params, tokens, cache, cfg: ModelConfig):
    """Run the prompt block through the model, filling the cache.
    Returns (last-position logits (B, V), cache)."""
    x, cache = forward(params, tokens, cfg, cache=cache)
    return _logits_chunk(params, x[:, -1:, :], cfg)[:, 0], cache


def decode_step(params, token, cache, cfg: ModelConfig):
    """One decode step; token (B, 1).  Returns (logits (B, V), cache)."""
    x, cache = forward(params, token, cfg, cache=cache)
    return _logits_chunk(params, x, cfg)[:, 0], cache
