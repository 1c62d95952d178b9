"""arch-id -> config registry: only the architectures the port runs."""

from __future__ import annotations

import importlib

ARCH_IDS = ["stablelm-1.6b"]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str, variant: str = "full"):
    """variant: 'full' (published widths) | 'smoke' (CPU-runnable)."""
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported; ported: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.FULL if variant == "full" else mod.SMOKE
