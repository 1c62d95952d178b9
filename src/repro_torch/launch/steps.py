"""Step functions for serving: greedy prefill, the batch scheduler's decode
step and the masked slot decode.

Mirrors `repro.launch.steps` (`make_prefill_step`, `make_serve_step`,
`make_decode_step_slots`).
PyTorch runs eagerly, so a step is a plain closure; the cache it is given is
updated in place and returned.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ModelConfig):
    """Greedy prefill: (params, tokens (B, T), cache, **extras) -> (token
    (B, 1), cache); extras are the family's `patches` / `frames`."""

    def prefill_step(params, tokens, cache, **extras):
        logits, cache = tf.prefill(params, tokens, cache, cfg, **extras)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step on a scalar-pos cache (the batch scheduler):
    (params, token (B, 1), cache) -> (token, cache).  Every row advances."""

    def serve_step(params, token, cache):
        logits, cache = tf.decode_step(params, token, cache, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return serve_step


def make_decode_step_slots(cfg: ModelConfig):
    """Masked continuous-batching decode step over the slot grid:
    (params, token (B, 1), cache{pos: (B,)}, active (B,) bool) -> (token, cache).

    Every slot computes every step, so the batch shape never changes and
    every projection stays one broadcast-weight bgemv launch at any
    occupancy.  Inactive slots' positions are frozen: a freed slot neither
    advances nor overflows its KV row while it waits for the next admission.
    The cache may be dense or paged, in the model dtype or int8; a freed
    paged slot's table row points at the trash page (the scheduler's job),
    so its masked write lands there.
    """

    def decode_step_slots(params, token, cache, active):
        pos0 = cache["pos"]
        logits, cache = tf.decode_step(params, token, cache, cfg)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        cache["pos"] = torch.where(active, pos0 + 1, pos0)
        return next_tok, cache

    return decode_step_slots
