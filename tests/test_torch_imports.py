"""Structural rules of the port, read from its source with `ast`.

- Nothing under src/repro_torch/, nor chip_smoke.py, imports jax or the
  JAX package `repro`.
- kernels/ops.py catches no exception: a CUDA tensor goes to its kernel or
  the call raises; nothing falls back to the plain version.
- `reference_mode` (the explicit switch to the plain versions on the card)
  is used by no module under launch/, models/ or core/.
- Asking serve() for CUDA without a GPU raises instead of running on the CPU.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _tree(path: Path) -> ast.AST:
    return ast.parse(path.read_text(), filename=str(path))


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [m for m in _imported_modules(_tree(path))
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_wrappers_catch_nothing():
    handlers = [n.lineno for n in ast.walk(_tree(PKG / "kernels" / "ops.py"))
                if isinstance(n, ast.Try) and n.handlers]
    assert not handlers, f"kernels/ops.py catches exceptions at lines {handlers}"


def test_reference_mode_stays_out_of_the_serving_path():
    users = []
    for sub in ("launch", "models", "core"):
        for path in (PKG / sub).rglob("*.py"):
            for node in ast.walk(_tree(path)):
                name = getattr(node, "id", None) or getattr(node, "attr", None)
                alias = getattr(node, "name", None)
                if "reference_mode" in (name, alias):
                    users.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not users, users


def test_serve_on_cuda_without_a_gpu_raises(monkeypatch):
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve("stablelm-1.6b", "smoke", requests=1, verbose=False, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        serve("stablelm-1.6b", "smoke", requests=1, verbose=False)  # the default
