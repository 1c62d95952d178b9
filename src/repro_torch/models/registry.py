"""arch-id -> config registry: only the architectures the port runs."""

from __future__ import annotations

import importlib

ARCH_IDS = ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-1.2b", "moonshot-v1-16b-a3b", "grok-1-314b",
            "paligemma-3b", "whisper-large-v3"]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str, variant: str = "full"):
    """variant: 'full' (published widths) | 'smoke' (CPU-runnable)."""
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported; ported: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.FULL if variant == "full" else mod.SMOKE
