"""The port's continuous-batching serve against the JAX serve: same params,
same prompts, equal greedy tokens (the cells of tests/test_serve.py)."""

import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.launch.serve import serve as jax_serve
from repro.models import transformer as jtf
from repro.models.registry import get_config as jax_config
from repro_torch.launch.serve import serve
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import get_config

ARCH = "stablelm-1.6b"
NO_EOS = -1


def _prompts(plens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=(pl,), dtype=np.int32) for pl in plens]


def _converted_params(seed=0):
    """JAX's init_params(PRNGKey(seed)) — what JAX serve builds — as the
    port's params."""
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jax_config(ARCH, "smoke"))
    return from_jax_params(jax.tree.map(np.asarray, jparams), get_config(ARCH, "smoke"),
                           device="cpu")


@pytest.mark.parametrize("plens,gen_lens,seed", [
    ([8] * 5, [3, 7, 4, 6, 5], 0),     # mixed budgets, slot reuse at batch 2
    ([8, 14, 5, 11], [6, 10, 4, 8], 11),  # ragged prompts: one prefill per length
])
def test_serve_matches_jax_serve(plens, gen_lens, seed):
    prompts = _prompts(plens, get_config(ARCH, "smoke").vocab, seed)
    want = jax_serve(ARCH, "smoke", batch=2, gen_lens=gen_lens, eos=NO_EOS,
                     verbose=False, prompts=prompts)
    got = serve(ARCH, "smoke", batch=2, gen_lens=gen_lens, eos=NO_EOS,
                verbose=False, prompts=prompts, params=_converted_params(),
                device="cpu")
    assert got["outputs"] == want["outputs"]
    assert got["completed"] == len(prompts)
    assert [len(o) for o in got["outputs"]] == gen_lens
    for key in ("tokens", "prefills", "decode_steps"):
        assert got[key] == want[key], key
    assert got["occupancy"] == pytest.approx(want["occupancy"])


def test_eos_and_degenerate_budgets_match_jax_serve():
    """An EOS taken from the free-running outputs stops that request early,
    and 0/1-token budgets finish on the prefill token, as in JAX serve."""
    prompts = _prompts([8] * 4, get_config(ARCH, "smoke").vocab, 3)
    params = _converted_params()
    free = serve(ARCH, "smoke", batch=2, gen_lens=[12] * 4, eos=NO_EOS,
                 verbose=False, prompts=prompts, params=params, device="cpu")
    eos = free["outputs"][0][2]
    got = serve(ARCH, "smoke", batch=2, gen_lens=[12, 0, 1, 12], eos=eos,
                verbose=False, prompts=prompts, params=params, device="cpu")
    want = jax_serve(ARCH, "smoke", batch=2, gen_lens=[12, 0, 1, 12], eos=eos,
                     verbose=False, prompts=prompts)
    assert got["outputs"] == want["outputs"]
    assert got["outputs"][0][-1] == eos
    assert got["completed"] == 4


def test_unported_options_raise():
    for kw in ({"scheduler": "batch", "speculate": 2}, {"prefill_chunk": 4}, {"speculate": 2},
               {"faults": "exhaust@0"}, {"deadline_ms": 50.0}, {"check_invariants": True},
               {"tp": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve(ARCH, "smoke", requests=1, verbose=False, device="cpu", **kw)


@pytest.mark.parametrize("kw, label", [
    ({"prefill_chunk": 4}, "ROADMAP §1: serving options"),
    ({"speculate": 2}, "ROADMAP §1: serving options"),
    ({"faults": "exhaust@0"}, "ROADMAP §1: serving options"),
    ({"deadline_ms": 50.0}, "ROADMAP §1: serving options"),
    ({"check_invariants": True}, "ROADMAP §1: serving options"),
    ({"tp": 2}, "ROADMAP §1: tensor parallelism"),
])
def test_unported_options_name_their_roadmap_label(kw, label):
    with pytest.raises(NotImplementedError, match=label):
        serve(ARCH, "smoke", requests=1, verbose=False, device="cpu", **kw)


def test_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--batch", "2", "--prompt-len", "6", "--gen", "3"],
        capture_output=True, text=True, timeout=120, check=True)
    assert "[serve] stablelm-1.6b (continuous): 3 requests, 9 tokens" in out.stdout
