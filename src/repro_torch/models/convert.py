"""Load params exported from the JAX package (as numpy arrays) into the
port's layout.

The reference stacks every per-layer leaf along a leading layer axis (for
`lax.scan`); the port keeps one dict per layer, so stacked leaves are sliced
per layer.  Values are copied exactly, bfloat16 included (numpy carries it
as the `ml_dtypes` bfloat16 type, whose bits are torch's bfloat16 bits).

Packed int8 weights (the reference's `QuantizedTensor`, from
`layers.quantize_weights`) are recognised by their fields (`values`,
`scales`, `block`, `transposed`), never by importing the JAX package, and
become the port's `core.quant.QuantizedTensor`; a stacked leaf's values and
scales are sliced per layer in lockstep.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.transformer import check_supported

_PACKED_FIELDS = ("values", "scales", "block", "transposed")


def to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)  # owned and writable: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_packed(node) -> bool:
    return all(hasattr(node, f) for f in _PACKED_FIELDS)


def _tree(node, fn):
    """Map fn over the array leaves; a packed leaf maps its values and scales
    with the same fn (the same layer slice) and keeps block and layout."""
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if _is_packed(node):
        return QuantizedTensor(values=fn(node.values), scales=fn(node.scales),
                               block=tuple(int(b) for b in node.block),
                               transposed=bool(node.transposed))
    return fn(node)


#: the stacked per-layer groups of a params tree: the decoder-only stacks'
#: "layers", the audio family's encoder and decoder blocks
_STACKS = ("layers", "enc_layers", "dec_layers")


def _depth(node) -> int:
    """The leading (layer) extent of a stacked group."""
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int(np.shape(node.values if _is_packed(node) else node)[0])


def from_jax_params(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """`tree` is a params pytree of `repro.models.transformer.init_params`
    (any family the port runs) with every leaf a numpy array (e.g.
    `jax.tree.map(np.asarray, params)`), projection weights optionally
    packed by `layers.quantize_weights`.  Returns the port's params on
    `device`: the same leaf names and dtypes (f32 leaves of a bf16 model
    stay f32: an rwkv block's decay_w0 and u, a Mamba2 block's a_log,
    dt_bias and d_skip; a MoE layer's router), with every stacked group
    ("layers"; the audio family's "enc_layers" and "dec_layers", whose
    cross-attention "xattn", its norm "ln_x" and the MLP biases come along)
    a list of per-layer dicts (a MoE layer's (L, E, d, f) expert stacks
    become (E, d, f), packed or not) whose nested dicts (rwkv's "tm" /
    "cm", a Mamba2 block's "norm" / "gate_norm") are sliced per layer too.
    The hybrid family's "shared_attn" (one block, not stacked) and
    "shared_lora" (stacked over the shared block's occurrences, which the
    forward indexes) and the audio family's "enc_final_norm" are carried as
    they are."""
    check_supported(cfg)
    out = {k: _tree(v, lambda a: to_tensor(a, device))
           for k, v in tree.items() if k not in _STACKS}
    for key in _STACKS:
        if key in tree:
            out[key] = [_tree(tree[key], lambda a, i=i: to_tensor(np.asarray(a)[i], device))
                        for i in range(_depth(tree[key]))]
    return out
