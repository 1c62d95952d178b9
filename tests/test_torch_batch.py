"""The port's batch scheduler (`serve(scheduler="batch")`) on the dense
family against JAX serve with backend="ref", on the CPU.

Same params (JAX's init_params(PRNGKey(0)), converted), same prompts: equal
greedy tokens and equal scheduler stats (prefills, decode steps, occupancy,
statuses, preemptions, rejections, peak pages live) for the dense cache,
int8 weights, the int8 KV cache, the paged cache, a pool that preempts,
pools too small for a group or for a row, and mixed budgets with EOS.  The
smoke model is f32, where the ref backend and the port's plain versions
agree (int8 weights and KV dequantize in f32 on both sides).
"""

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
STAT_KEYS = ("completed", "tokens", "prefills", "decode_steps", "status", "preemptions",
             "rejections", "finish_step", "admit_step")


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(jax.random.PRNGKey(0), jax_config(ARCH, "smoke"))
    return from_jax_params(jax.tree.map(np.asarray, jparams), get_config(ARCH, "smoke"),
                           device="cpu")


def _prompts(n, plen, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=(plen,), dtype=np.int32) for _ in range(n)]


def _both(params, **kw):
    kw = dict(kw, scheduler="batch", verbose=False)
    want = jax_serve(ARCH, "smoke", backend="ref", **kw)
    got = serve(ARCH, "smoke", params=params, device="cpu", **kw)
    return got, want


def _assert_same(got, want):
    assert got["outputs"] == want["outputs"]
    for key in STAT_KEYS:
        assert got[key] == want[key], key
    assert got["occupancy"] == pytest.approx(want["occupancy"])
    assert got.get("pages_live") == want.get("pages_live")
    assert got.get("kv_page_size") == want.get("kv_page_size")


CI_GEN = np.random.default_rng(0).integers(4, 9, size=6).tolist()


@pytest.mark.parametrize("kw", [
    {},                                              # dense cache
    dict(quantize="int8"),                           # packed projections
    dict(kv_cache="int8"),                           # int8 KV cache
    dict(kv_page_size=4),                            # paged, default pool
    dict(kv_page_size=4, kv_cache="int8"),
    dict(kv_page_size=4, pool_pages=7),              # growth preempts: full recompute
    dict(kv_page_size=4, pool_pages=5),              # a row owns the pool: rejected
    dict(kv_page_size=4, pool_pages=3),              # no request fits: all rejected
], ids=["dense", "quantize-int8", "kv-int8", "paged", "paged-kv-int8", "pool7-preempts",
        "pool5-row-rejected", "pool3-all-rejected"])
def test_batch_serve_matches_jax(params, kw):
    got, want = _both(params, batch=3, prompts=_prompts(6, 10, 0), gen_lens=CI_GEN,
                      eos=NO_EOS, **kw)
    _assert_same(got, want)
    pool = kw.get("pool_pages")
    if pool == 7:
        assert got["preemptions"] >= 1 and "preempted_resumed" in got["status"]
    if pool == 5:
        assert "rejected" in got["status"] and "ok" in got["status"]
    if pool == 3:
        assert got["status"] == ["rejected"] * 6 and got["prefills"] == 0


def test_small_pool_keeps_the_default_pools_tokens(params):
    """A preempted request is re-served from its original prompt, so every
    completed request gives the unpressured run's tokens."""
    kw = dict(batch=3, prompts=_prompts(6, 10, 0), gen_lens=CI_GEN, eos=NO_EOS,
              scheduler="batch", verbose=False, params=params, device="cpu", kv_page_size=4)
    free = serve(ARCH, "smoke", **kw)
    pressed = serve(ARCH, "smoke", pool_pages=7, **kw)
    assert pressed["preemptions"] >= 1
    assert pressed["outputs"] == free["outputs"]


@pytest.mark.parametrize("batch", [2, 4])
def test_mixed_budgets_and_eos_match_jax(params, batch):
    """Budgets of 0, 1 and more, and an EOS taken from the free-running
    outputs: finished rows idle until their group drains."""
    prompts = _prompts(5, 8, 3)
    free = serve(ARCH, "smoke", batch=batch, prompts=prompts, gen_lens=[12] * 5, eos=NO_EOS,
                 scheduler="batch", verbose=False, params=params, device="cpu")
    eos = free["outputs"][0][2]
    got, want = _both(params, batch=batch, prompts=prompts, gen_lens=[12, 0, 1, 7, 12],
                      eos=eos)
    _assert_same(got, want)
    assert got["outputs"][0][-1] == eos and len(got["outputs"][1]) == 1
    assert got["occupancy"] < 1.0


def test_ragged_prompts_raise(params):
    prompts = _prompts(2, 8, 1) + _prompts(1, 9, 2)
    with pytest.raises(ValueError) as want:
        jax_serve(ARCH, "smoke", batch=2, prompts=prompts, gen=2, scheduler="batch",
                  verbose=False)
    with pytest.raises(ValueError) as got:
        serve(ARCH, "smoke", batch=2, prompts=prompts, gen=2, scheduler="batch",
              verbose=False, params=params, device="cpu")
    assert str(got.value) == str(want.value)


def test_prefill_chunk_needs_the_continuous_scheduler():
    with pytest.raises(ValueError) as want:
        jax_serve(ARCH, "smoke", requests=1, prefill_chunk=4, scheduler="batch", verbose=False)
    with pytest.raises(ValueError) as got:
        serve(ARCH, "smoke", requests=1, prefill_chunk=4, scheduler="batch", verbose=False,
              device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(speculate=2), dict(faults="exhaust@0"),
                                dict(deadline_ms=50.0), dict(check_invariants=True),
                                dict(tp=2)])
def test_unported_options_raise_under_batch(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve(ARCH, "smoke", requests=1, scheduler="batch", verbose=False, device="cpu", **kw)


def test_cli_batch_scheduler_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--scheduler",
         "batch", "--kv-page-size", "4", "--requests", "3", "--batch", "2", "--prompt-len",
         "6", "--gen", "3"],
        capture_output=True, text=True, timeout=120, check=True)
    assert "[serve] stablelm-1.6b (batch): 3 requests, 9 tokens" in out.stdout
    assert "pages" in out.stdout
