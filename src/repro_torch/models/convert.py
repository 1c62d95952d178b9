"""Load params exported from the JAX package (as numpy arrays) into the
port's layout.

The reference stacks every per-layer leaf along a leading layer axis (for
`lax.scan`); the port keeps one dict per layer, so stacked leaves are sliced
per layer.  Values are copied exactly, bfloat16 included (numpy carries it
as the `ml_dtypes` bfloat16 type, whose bits are torch's bfloat16 bits).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_supported


def to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)  # owned and writable: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def from_jax_params(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """`tree` is the dense-family params pytree of
    `repro.models.transformer.init_params` with every leaf a numpy array
    (e.g. `jax.tree.map(np.asarray, params)`).  Returns the port's params on
    `device`: the same leaf names, with "layers" a list of per-layer dicts."""
    check_supported(cfg)
    out = {k: _tree(v, lambda a: to_tensor(a, device))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_tree(tree["layers"], lambda a, i=i: to_tensor(np.asarray(a)[i], device))
                     for i in range(cfg.n_layers)]
    return out
