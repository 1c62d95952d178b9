"""Model assembly for the dense, moe, rwkv, hybrid, vlm and audio families:
params, forward, cache, prefill, decode.

Mirrors `repro.models.transformer` for those families.  The moe family is
the dense stack with `models.moe.moe_layer` in place of the MLP (its aux
loss dropped: serving never reads it).  The vlm family (paligemma) is the
dense stack with (stub) patch embeddings in front of the prompt, seen
bidirectionally (the prefix-LM mask, prefix_len = n_prefix), text causal
after them.  The audio family (whisper) is an encoder-decoder: a
non-causal encoder over (stub) frame embeddings plus sinusoidal positions,
and a decoder of causal self-attention, non-causal cross-attention to the
encoder output and a biased gelu MLP, neither with rope.  Params are a dict
with the reference's leaf names; where the reference stacks layers along a
leading axis for `lax.scan`, the port keeps a Python list of per-layer dicts
and loops over it.  The cache keeps the reference layouts: (L, B, S, KVH,
hd) per K and V dense, or (L, num_pages, page_size, KVH, hd) paged with a
(B, max_pages) page table; int8 values with (..., 1) f32 scales when
cfg.kv_cache_dtype is "int8".  It is updated IN PLACE: every function that
takes a cache returns a dict over the same buffers.  The rwkv family keeps
a recurrent state instead (`init_cache`), which forward replaces.  The
hybrid family (zamba2) keeps per-layer Mamba2 states and one KV cache per
occurrence of its shared attention block, all written in place.  The audio
family's cache holds the encoder output "enc" beside the decoder's K/V.

Public API:
    init_params(cfg, seed, device)        -> params
    init_cache(cfg, batch, max_len, ...)  -> cache (dense or paged)
    insert_slots_cache / graft_pages / copy_pages -> admission and CoW
    forward(params, tokens, cfg, cache, patches=, frames=)
                                          -> (hidden (B, T, d), cache)
    prefill(params, tokens, cache, cfg, patches=, frames=)
                                          -> (last-position logits (B, V), cache)
    decode_step(params, token, cache, cfg)-> (logits (B, V), cache)
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import blas
from repro_torch.models import layers, mamba, moe, rwkv
from repro_torch.models.layers import AttnConfig

#: families whose cache has one row per slot (the continuous scheduler, the
#: paged cache and speculation need it), as the reference lists them; rwkv
#: and hybrid keep a recurrent state, audio a batch-wide scalar position.
SLOT_CACHE_FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for config options this slice of the port does not run."""
    unported = {
        "family": cfg.family not in ("dense", "moe", "rwkv", "hybrid", "vlm", "audio"),
        "qk_norm": cfg.qk_norm,
        "parallel_block": cfg.parallel_block,
        "kv_cache_dtype": cfg.kv_cache_dtype not in ("model", "int8"),
        "weight_dtype": cfg.weight_dtype != "model",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.arch_id}: {bad} not ported yet (ROADMAP §1)")


def _attn_cfg(cfg: ModelConfig, causal: bool = True) -> AttnConfig:
    """The audio family never ropes (reference transformer.py:36-48)."""
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                      head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                      use_bias=cfg.use_bias, causal=causal, use_rope=cfg.family != "audio")


def dense_block(params, x, cfg: ModelConfig, *, positions, cache=None, prefix_len=None):
    """Returns (x, new_cache).  Both skip connections ride the fused
    epilogues of the wo and w_down projections; the moe family adds its
    MoE layer's output to the attention's instead (reference
    transformer.py:91-93).  prefix_len: the vlm prefill's prefix-LM mask."""
    a, new_cache = layers.attention_layer(
        params["attn"], layers.apply_norm(params["ln1"], x, cfg.norm),
        _attn_cfg(cfg), positions=positions, cache=cache, prefix_len=prefix_len, residual=x)
    h = layers.apply_norm(params["ln2"], a, cfg.norm)
    if cfg.family == "moe":
        m, _ = moe.moe_layer(params["ffn"], h, cfg.moe, cfg.act)
        return a + m, new_cache
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
    if cfg.family == "rwkv":
        params["layers"] = [rwkv.init_rwkv_block(gen, cfg, dtype, device)
                            for _ in range(cfg.n_layers)]
        return params
    if cfg.family == "hybrid":
        return _init_hybrid(gen, cfg, params, dtype, device)
    if cfg.family == "audio":
        return _init_audio(gen, cfg, params, dtype, device)

    def ffn():
        if cfg.family == "moe":
            return moe.init_moe(gen, d, cfg.moe, cfg.act, dtype, device)
        return layers.init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device)

    params["layers"] = [
        {"ln1": layers.init_norm(d, cfg.norm, dtype, device),
         "attn": layers.init_attention(gen, _attn_cfg(cfg), dtype, device),
         "ffn": ffn(),
         "ln2": layers.init_norm(d, cfg.norm, dtype, device)}
        for _ in range(cfg.n_layers)
    ]
    return params


def _init_audio(gen: torch.Generator, cfg: ModelConfig, params: dict, dtype, device) -> dict:
    """Encoder blocks (non-causal self-attention, the MLP), decoder blocks
    (causal self-attention "attn", non-causal cross-attention "xattn" with
    its norm "ln_x", the MLP) and the encoder's final norm, as the
    reference's init_encoder_block / init_decoder_block."""
    d = cfg.d_model

    def norm():
        return layers.init_norm(d, cfg.norm, dtype, device)

    def attn():
        return layers.init_attention(gen, _attn_cfg(cfg), dtype, device)

    def ffn():
        return layers.init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, device, cfg.use_bias)

    params["enc_layers"] = [{"ln1": norm(), "ln2": norm(), "attn": attn(), "ffn": ffn()}
                            for _ in range(cfg.encoder.n_layers)]
    params["dec_layers"] = [{"ln1": norm(), "ln_x": norm(), "ln2": norm(), "attn": attn(),
                             "xattn": attn(), "ffn": ffn()} for _ in range(cfg.n_layers)]
    params["enc_final_norm"] = norm()
    return params


def _init_hybrid(gen: torch.Generator, cfg: ModelConfig, params: dict, dtype, device) -> dict:
    """Mamba2 blocks, the shared attention block (gelu MLP) and its
    per-occurrence LoRA factors, stacked over the n_layers // every
    occurrences; the "*b" factors start at zero, as in the reference."""
    params["layers"] = [mamba.init_mamba_block(gen, cfg, dtype, device)
                        for _ in range(cfg.n_layers)]
    s = cfg.ssm
    if not s.shared_attn_every:
        return params
    d = cfg.d_model
    params["shared_attn"] = {
        "ln1": layers.init_norm(d, cfg.norm, dtype, device),
        "ln2": layers.init_norm(d, cfg.norm, dtype, device),
        "attn": layers.init_attention(gen, _attn_cfg(cfg), dtype, device),
        "ffn": layers.init_mlp(gen, d, cfg.d_ff, "gelu", dtype, device),
    }
    if s.shared_attn_lora_rank:
        n_occ, r = cfg.n_layers // s.shared_attn_every, s.shared_attn_lora_rank
        widths = {"q": cfg.n_heads * cfg.hd, "k": cfg.n_kv * cfg.hd, "v": cfg.n_kv * cfg.hd}
        lora = {}
        for name, width in widths.items():
            lora[name + "a"] = layers._normal(gen, (n_occ, d, r), d ** -0.5, dtype, device)
            lora[name + "b"] = torch.zeros((n_occ, r, width), dtype=dtype, device=device)
        params["shared_lora"] = lora
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def forward(params, tokens, cfg: ModelConfig, cache=None, *, patches=None, frames=None):
    """tokens (B, T) int, with the family extras: the vlm's patches (B,
    n_prefix, d) in front of the tokens (a prefill: the decode step finds
    them in the cache), the audio family's frames (B, F, d) for its encoder
    (a prefill, or a cache-less forward; a decode step reads the encoder
    output from cache["enc"]).  Returns (final-normed hidden (B, T', d),
    cache), T' = n_prefix + T where patches were given."""
    b, t = tokens.shape
    x = layers.embed(params["embed"], tokens, scale=cfg.embed_scale)
    pos = cache["pos"] if cache is not None else 0
    prefix_len = None
    if cfg.family == "vlm" and patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        t = x.shape[1]
        prefix_len = cfg.n_prefix
    if cfg.family == "rwkv":
        states = []
        for i, lp in enumerate(params["layers"]):
            lc = None if cache is None else {"tm": {k: v[i] for k, v in cache["tm"].items()},
                                             "cm": {k: v[i] for k, v in cache["cm"].items()}}
            x, st = rwkv.rwkv_block(lp, x, cfg, lc)
            states.append(st)
        new_cache = None
        if cache is not None:
            new_cache = {grp: {k: torch.stack([st[grp][k] for st in states])
                               for k in cache[grp]} for grp in ("tm", "cm")}
            new_cache["pos"] = pos + t
        return layers.apply_norm(params["final_norm"], x, cfg.norm), new_cache
    if cfg.family == "audio":
        x, new_cache = _audio_forward(params, x, frames, cfg, cache)
        return layers.apply_norm(params["final_norm"], x, cfg.norm), new_cache
    steps = torch.arange(t, device=tokens.device)
    if isinstance(pos, int):
        positions = steps + pos
    else:
        # per-slot serving cache: each slot at its own ragged position
        positions = pos.to(torch.int64)[:, None] + steps[None, :]
    if cfg.family == "hybrid":
        x, new_cache = _hybrid_forward(params, x, cfg, positions, cache)
        return layers.apply_norm(params["final_norm"], x, cfg.norm), new_cache
    keys = [k for k in _KV_KEYS if cache is not None and k in cache]
    for i, lp in enumerate(params["layers"]):
        lc = None
        if cache is not None:
            # one page table serves every layer; each layer sees its slice
            # of the buffers
            lc = {**{k: cache[k][i] for k in keys}, "pos": pos}
            if "page_table" in cache:
                lc["page_table"] = cache["page_table"]
        x, _ = dense_block(lp, x, cfg, positions=positions, cache=lc, prefix_len=prefix_len)
    new_cache = None if cache is None else {**cache, "pos": pos + t}
    return layers.apply_norm(params["final_norm"], x, cfg.norm), new_cache


def _hybrid_forward(params, x, cfg: ModelConfig, positions, cache=None):
    """Zamba2: the Mamba2 stack with the shared attention block after every
    `every` blocks while occurrences remain (FULL: after blocks 5, 11, ...,
    35; blocks 36-37 have none).  Each block's state and each occurrence's
    K/V are written into the cache IN PLACE."""
    s = cfg.ssm
    every = s.shared_attn_every or (cfg.n_layers + 1)
    n_occ = cfg.n_layers // every if s.shared_attn_every else 0
    pos = cache["pos"] if cache is not None else None
    occ = 0
    for i, lp in enumerate(params["layers"]):
        lc = None
        if cache is not None:
            lc = {k: cache["mamba"][k][i] for k in ("conv", "h")}
        x, st = mamba.mamba_block(lp, x, cfg, lc)
        if cache is not None:
            for k in ("conv", "h"):
                cache["mamba"][k][i].copy_(st[k])
        if (i + 1) % every == 0 and occ < n_occ:
            ac = None
            if cache is not None:
                ac = {"k": cache["attn"]["k"][occ], "v": cache["attn"]["v"][occ], "pos": pos}
            x, _ = _shared_attn_block(params, x, cfg, positions, occ, ac)
            occ += 1
    if cache is None:
        return x, None
    # the reference advances pos through the shared block's cache: a stack
    # with no occurrence keeps it
    return x, {**cache, "pos": pos + x.shape[1] if occ else pos}


def _shared_attn_block(params, x, cfg: ModelConfig, positions, occ: int, cache=None):
    """The shared block at occurrence `occ`: wq/wk/wv plus that occurrence's
    LoRA delta (an f32 product rounded to the weight dtype before the add),
    attention with the residual x, the gelu MLP with the residual a."""
    sp = params["shared_attn"]
    attn_params = sp["attn"]
    if "shared_lora" in params:
        lo = params["shared_lora"]

        def lora(base, a, b):
            return base + blas.matmul(a[occ].float(), b[occ].float()).to(base.dtype)

        attn_params = dict(attn_params, wq=lora(attn_params["wq"], lo["qa"], lo["qb"]),
                           wk=lora(attn_params["wk"], lo["ka"], lo["kb"]),
                           wv=lora(attn_params["wv"], lo["va"], lo["vb"]))
    a, new_cache = layers.attention_layer(
        attn_params, layers.apply_norm(sp["ln1"], x, cfg.norm), _attn_cfg(cfg),
        positions=positions, cache=cache, residual=x)
    x = layers.mlp(sp["ffn"], layers.apply_norm(sp["ln2"], a, cfg.norm), "gelu", residual=a)
    return x, new_cache


def sinusoidal(t: int, d: int, dtype, device) -> torch.Tensor:
    """Whisper-style positions (t, d): sin then cos of pos * 10000^(-2i/d),
    computed in f32 and rounded to dtype, as the reference's."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    return torch.cat([torch.sin(pos * div), torch.cos(pos * div)], dim=-1).to(dtype)


def encode(params, frames, cfg: ModelConfig):
    """The audio encoder: frames (B, F, d) (the stub frontend's embeddings)
    plus sinusoidal positions through the non-causal blocks and the final
    norm -> (B, F, d)."""
    b, f, d = frames.shape
    x = frames + sinusoidal(f, d, frames.dtype, frames.device)[None]
    for lp in params["enc_layers"]:
        x = encoder_block(lp, x, cfg)
    return layers.apply_norm(params["enc_final_norm"], x, cfg.norm)


def encoder_block(params, x, cfg: ModelConfig):
    """One encoder block: non-causal self-attention, the MLP, both with their
    residuals in the fused epilogues."""
    f = x.shape[1]
    h, _ = layers.attention_layer(params["attn"], layers.apply_norm(params["ln1"], x, cfg.norm),
                                  _attn_cfg(cfg, causal=False),
                                  positions=torch.arange(f, device=x.device), residual=x)
    return layers.mlp(params["ffn"], layers.apply_norm(params["ln2"], h, cfg.norm), cfg.act,
                      residual=h)


def decoder_block(params, x, enc, cfg: ModelConfig, *, positions, cache=None):
    """One decoder block: causal self-attention (over the cache when given),
    cross-attention from every decoder token to the encoder output (K/V
    projected from enc on every call, as the reference does; non-causal,
    every row over all F frames), the MLP.  Returns (x, new_cache)."""
    h, new_cache = layers.attention_layer(
        params["attn"], layers.apply_norm(params["ln1"], x, cfg.norm), _attn_cfg(cfg),
        positions=positions, cache=cache, residual=x)
    hx = layers.apply_norm(params["ln_x"], h, cfg.norm)
    xp = params["xattn"]
    if cfg.use_bias:
        q = blas.matmul_fused(hx, xp["wq"], bias=xp["bq"])
        k = blas.matmul_fused(enc, xp["wk"], bias=xp["bk"])
        v = blas.matmul_fused(enc, xp["wv"], bias=xp["bv"])
    else:
        q, k, v = blas.matmul(hx, xp["wq"]), blas.matmul(enc, xp["wk"]), blas.matmul(enc, xp["wv"])
    b, t, _ = hx.shape
    f = enc.shape[1]
    ho = layers.attention_dispatch(q.reshape(b, t, cfg.n_heads, cfg.hd),
                                   k.reshape(b, f, cfg.n_kv, cfg.hd),
                                   v.reshape(b, f, cfg.n_kv, cfg.hd), causal=False,
                                   groups=cfg.n_heads // cfg.n_kv)
    x = blas.matmul_fused(ho.reshape(b, t, cfg.n_heads * cfg.hd), xp["wo"], residual=h)
    x = layers.mlp(params["ffn"], layers.apply_norm(params["ln2"], x, cfg.norm), cfg.act,
                   residual=x)
    return x, new_cache


def _audio_forward(params, x_dec, frames, cfg: ModelConfig, cache=None):
    """Whisper (reference transformer.py:361-444): the encoder over frames
    when they are given (its output written into cache["enc"] IN PLACE when
    there is a cache), else the encoder output cache["enc"]; then the
    decoder with sinusoidal positions (the table over the cache's length,
    sliced at pos, when there is a cache).  The reference decides by
    whether the cache holds "enc", which its init_cache always allocates,
    so its serve never runs the encoder (ROADMAP §3); the port encodes
    whatever frames it is given."""
    b, t, d = x_dec.shape
    if frames is not None:
        enc = encode(params, frames.to(x_dec.dtype), cfg)
        if cache is not None:
            cache["enc"].copy_(enc)
    elif cache is not None:
        enc = cache["enc"]
    else:
        raise ValueError("the audio family needs frames, or a cache holding the encoder output")
    if cache is not None:
        pos = cache["pos"]
        pe = sinusoidal(cache["k"].shape[2], d, x_dec.dtype, x_dec.device)
        start = min(max(pos, 0), pe.shape[0] - t)  # the reference's dynamic_slice clamp
        x = x_dec + pe[start:start + t][None]
        positions = torch.arange(t, device=x_dec.device) + pos
    else:
        x = x_dec + sinusoidal(t, d, x_dec.dtype, x_dec.device)[None]
        positions = torch.arange(t, device=x_dec.device)
    for i, lp in enumerate(params["dec_layers"]):
        lc = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        x, _ = decoder_block(lp, x, enc, cfg, positions=positions, cache=lc)
    return x, (None if cache is None else {**cache, "pos": pos + t})


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

#: per-layer cache buffers: values, and the int8 cache's f32 scales
_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, per_slot: bool = False,
               page_size: int = 0, num_pages=None, device="cuda", enc_frames: int = 0) -> dict:
    """Zeroed KV cache.  per_slot=True gives a (batch,) int32 "pos"
    (continuous batching: every slot at its own position); otherwise "pos"
    is a Python int shared by every row.

    page_size > 0 gives the paged form: a pool (L, num_pages, page_size,
    KVH, hd) per K and V and a (batch, ceil(max_len / page_size)) int32
    "page_table" whose entries start at the trash page 0; num_pages
    defaults to 1 + batch * max_pages, dense capacity plus the trash page.
    cfg.kv_cache_dtype == "int8" stores int8 values with "k_scale" /
    "v_scale" buffers of the same shape with hd -> 1, f32.

    The rwkv family's cache is its recurrent state, per layer: "tm"
    {"x_prev": (L, B, d) in the model dtype, "s": (L, B, H, hd, hd) f32},
    "cm" {"x_prev": (L, B, d)}, and a scalar "pos"; it has no per-slot or
    paged form (ValueError), and kv_cache_dtype does not touch it.

    The hybrid family's: "mamba" {"conv": (L, B, K-1, d_xbc) in the model
    dtype, "h": (L, B, NH, N, P) f32}, "attn" {"k", "v": (max(n_occ, 1),
    B, max_len, KVH, hd) in the model dtype} and a scalar "pos"; no
    per-slot or paged form, and kv_cache_dtype="int8" leaves it in the
    model dtype, as the reference builds it.

    The audio family's: "enc" (B, enc_frames or encoder.n_frames, d), the
    decoder's "k"/"v" (L, B, max_len, KVH, hd), all in the model dtype
    (kv_cache_dtype="int8" too, as the reference builds it), and a scalar
    "pos"; no per-slot or paged form."""
    check_supported(cfg)
    if per_slot and cfg.family not in SLOT_CACHE_FAMILIES:
        raise ValueError(f"per-slot cache supports families {SLOT_CACHE_FAMILIES}, "
                         f"got {cfg.family!r}")
    if page_size and cfg.family not in SLOT_CACHE_FAMILIES:
        raise ValueError(f"paged KV cache supports families {SLOT_CACHE_FAMILIES}, "
                         f"got {cfg.family!r}")
    if cfg.family == "rwkv":
        d, hd, n = cfg.d_model, cfg.rwkv.head_dim, cfg.n_layers
        return {"tm": {"x_prev": torch.zeros((n, batch, d), dtype=cfg.torch_dtype, device=device),
                       "s": torch.zeros((n, batch, d // hd, hd, hd), dtype=torch.float32,
                                        device=device)},
                "cm": {"x_prev": torch.zeros((n, batch, d), dtype=cfg.torch_dtype, device=device)},
                "pos": 0}
    if cfg.family == "hybrid":
        s, _, nh, d_xbc = mamba._dims(cfg)
        n, dt = cfg.n_layers, cfg.torch_dtype
        n_occ = n // s.shared_attn_every if s.shared_attn_every else 0
        kv_shape = (max(n_occ, 1), batch, max_len, cfg.n_kv, cfg.hd)
        return {"mamba": {"conv": torch.zeros((n, batch, s.conv_kernel - 1, d_xbc), dtype=dt,
                                              device=device),
                          "h": torch.zeros((n, batch, nh, s.d_state, s.head_dim),
                                           dtype=torch.float32, device=device)},
                "attn": {key: torch.zeros(kv_shape, dtype=dt, device=device) for key in "kv"},
                "pos": 0}
    if cfg.family == "audio":
        dt = cfg.torch_dtype
        kv_shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
        return {"enc": torch.zeros((batch, enc_frames or cfg.encoder.n_frames, cfg.d_model),
                                   dtype=dt, device=device),
                **{key: torch.zeros(kv_shape, dtype=dt, device=device) for key in "kv"},
                "pos": 0}
    if page_size:
        max_pages = -(-max_len // page_size)
        if num_pages is None:
            num_pages = 1 + batch * max_pages
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv, cfg.hd)
    else:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        cache = {key: torch.zeros(shape, dtype=torch.int8, device=device) for key in "kv"}
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)
    else:
        cache = {key: torch.zeros(shape, dtype=cfg.torch_dtype, device=device) for key in "kv"}
    if page_size:
        cache["page_table"] = torch.zeros((batch, max_pages), dtype=torch.int32, device=device)
    cache["pos"] = torch.zeros(batch, dtype=torch.int32, device=device) if per_slot else 0
    return cache


def insert_slots_cache(cache: dict, mini: dict, slots) -> dict:
    """Graft rows of a freshly prefilled scalar-pos cache into serving slots,
    IN PLACE.  Row i of `mini` replaces slot slots[i] wholesale (values and,
    for an int8 cache, scales) and sets that slot's pos to mini's pos;
    slots[i] < 0 marks a padding row, dropped."""
    slots = torch.as_tensor(slots, dtype=torch.int64)
    rows = torch.nonzero(slots >= 0).flatten()
    dst = slots[rows].to(cache["k"].device)
    rows = rows.to(cache["k"].device)
    for key in _KV_KEYS:
        if key in cache:
            cache[key][:, dst] = mini[key][:, rows].to(cache[key].dtype)
    cache["pos"][dst] = mini["pos"]
    return cache


def graft_pages(cache: dict, mini: dict, rows, toks, pages, offs) -> dict:
    """Graft admission-prefill tokens into the paged pool, IN PLACE, token by
    token: token i copies mini row rows[i], position toks[i] (every layer,
    values and scales alike) into pool page pages[i] at row offs[i].  The
    scheduler lists only the unshared suffix of each admitted prompt: a
    matched prefix is page-table pointers and never touches the pool."""
    for key in _KV_KEYS:
        if key in cache:
            cache[key][:, pages, offs] = mini[key][:, rows, toks].to(cache[key].dtype)
    return cache


def copy_pages(cache: dict, src, dst) -> dict:
    """Copy-on-write: duplicate pool pages `src` into `dst` across every
    layer (values and scales alike), IN PLACE."""
    for key in _KV_KEYS:
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    return cache


def prefill(params, tokens, cache, cfg: ModelConfig, *, patches=None, frames=None):
    """Run the prompt block (behind the vlm's patches, beside the audio
    family's frames) through the model, filling the cache.
    Returns (last-position logits (B, V), cache)."""
    x, cache = forward(params, tokens, cfg, cache=cache, patches=patches, frames=frames)
    return _logits_chunk(params, x[:, -1:, :], cfg)[:, 0], cache


def decode_step(params, token, cache, cfg: ModelConfig):
    """One decode step; token (B, 1).  Returns (logits (B, V), cache)."""
    x, cache = forward(params, token, cfg, cache=cache)
    return _logits_chunk(params, x, cfg)[:, 0], cache
