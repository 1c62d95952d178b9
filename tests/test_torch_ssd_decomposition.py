"""The SSD kernel's decomposition (csrc/mamba2.cu), modelled in PyTorch on
the CPU and held against the JAX package.

The kernel runs the chunked Mamba2 recurrence as three launches: every
chunk's state increment dH_n = (b * exp(L_C - L))^T x and decay d_n =
exp(L_C) at once, then the carried state H_n = d_n H_{n-1} + dH_n element
by element across the chunks, then every chunk's outputs y = exp(L_t) (c
H_{n-1}) + A x at once, with A = (c b^T) * exp(min(L_t - L_s, 0)) on s <= t.
L, the chunk's inclusive cumsum of the log-decays, is summed and
differenced in f64 and each exponent rounded to f32 once.  `decomposed`
below repeats that arithmetic in plain PyTorch (f32, L in f64) and is held
against `repro.models.mamba.ssd_chunked` (y and the final state, from a
state and from zeros), the token-by-token oracle `repro.kernels.ref.ssd`
and the Pallas kernel `repro.kernels.ops.mamba2_ssd` in interpret mode (y
from zeros), on seeded numpy inputs: ragged T, chunk 8 and 64, and strong
decay (a_log down to -40 a step).

Tolerance: rtol = atol = 1e-5 against the f32 references, as
tests/test_torch_zamba.py holds the plain version; the decomposition
differs from them in summation order only.  `ssd_chunked` and the Pallas
kernel sum L in f32: under strong decay at chunk 8 (|L| up to ~320) an
exponent is the difference of two such sums, so their f32 rounding (320 *
2^-24 ~ 2e-5) sets the tolerance there: rtol = atol = 1e-4, chip_smoke's f32
gate.  At chunk 64 (|L| past 10^3) only the token oracle, which takes no
prefix sum, is a fair reference (1e-5).  bf16 y against the plain version:
1.6e-2 (one output rounding step).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba as jmamba
from repro_torch.kernels import mamba2

TOL = dict(rtol=1e-5, atol=1e-5)
STRONG_TOL = dict(rtol=1e-4, atol=1e-4)


def decomposed(x, a_log, b, c, h0=None, chunk: int = 64):
    """y (x's dtype) and h_fin (f32) by the kernel's three launches."""
    bh, t, p = x.shape
    n = b.shape[-1]
    ck = min(chunk, t)
    pad = (-t) % ck
    if pad:
        x, b, c = (F.pad(z, (0, 0, 0, pad)) for z in (x, b, c))
        a_log = F.pad(a_log, (0, pad))
    nc = x.shape[1] // ck
    xs, bs, cs = (z.reshape(bh, nc, ck, -1).float() for z in (x, b, c))
    L = torch.cumsum(a_log.reshape(bh, nc, ck).double(), dim=-1)      # (BH, n, C) f64
    lc = L[:, :, -1:]                                                   # L_C
    # 1. states: every chunk's increment and decay at once
    dec = torch.exp(lc[..., 0].float())                                 # (BH, n)
    dh = torch.einsum("bksn,bksp->bknp", bs * torch.exp((lc - L).float())[..., None], xs)
    # 2. the carried state, one multiply-add a state element a chunk
    h = torch.zeros((bh, n, p)) if h0 is None else h0.float().clone()
    entering = []
    for k in range(nc):
        entering.append(h)
        h = dec[:, k, None, None] * h + dh[:, k]
    hprev = torch.stack(entering, 1)                                    # (BH, n, N, P)
    # 3. outputs: every chunk at once, A once a chunk for all P columns
    e = (L[..., :, None] - L[..., None, :]).float()                    # (BH, n, C, C)
    a = (torch.einsum("bktn,bksn->bkts", cs, bs) * torch.exp(torch.clamp(e, max=0.0))
         * torch.tril(torch.ones(ck, ck)))
    inter = torch.einsum("bktn,bknp->bktp", cs, hprev)
    y = torch.exp(L.float())[..., None] * inter + torch.einsum("bkts,bksp->bktp", a, xs)
    return y.reshape(bh, nc * ck, p)[:, :t].to(x.dtype), h


def _inputs(bh, t, p, n, seed, strong=False):
    """x, a_log, b, c, h0 as f32 numpy arrays, as tests/test_torch_zamba.py
    makes them: a_log = -exp(N(0, 1)) * 0.3, or U(-40, 0) a step when
    `strong`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, t, p)).astype(np.float32)
    b, c = (rng.standard_normal((bh, t, n)).astype(np.float32) * 0.5 for _ in range(2))
    if strong:
        a = -40.0 * rng.random((bh, t)).astype(np.float32)
    else:
        a = (-np.exp(rng.standard_normal((bh, t))) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((bh, n, p)).astype(np.float32)
    return x, a, b, c, h0


def _t(z):
    return torch.from_numpy(np.array(z, np.float32))


CASES = [  # (T, chunk, P, N, strong decay)
    (64, 64, 16, 16, False), (100, 64, 16, 24, False), (21, 8, 16, 16, False),
    (5, 8, 8, 16, False), (19, 8, 16, 16, True), (40, 16, 16, 16, True),
]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t,chunk,p,n,strong", CASES)
def test_decomposition_matches_ssd_chunked(t, chunk, p, n, strong, with_h0):
    x, a, b, c, h0 = _inputs(3, t, p, n, seed=t + chunk, strong=strong)
    h0 = h0 if with_h0 else None
    wy, wh = jmamba.ssd_chunked(*(jnp.asarray(z) for z in (x, a, b, c)),
                                h0=None if h0 is None else jnp.asarray(h0), chunk=chunk)
    gy, gh = decomposed(*(_t(z) for z in (x, a, b, c)), h0=None if h0 is None else _t(h0),
                        chunk=chunk)
    tol = STRONG_TOL if strong else TOL
    assert torch.isfinite(gy).all() and torch.isfinite(gh).all()
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **tol)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **tol)


@pytest.mark.parametrize("t,chunk,p,n,strong", CASES)
def test_decomposition_matches_the_pallas_kernel(t, chunk, p, n, strong):
    x, a, b, c, _ = _inputs(2, t, p, n, seed=3 * t + chunk, strong=strong)
    want = jops.mamba2_ssd(*(jnp.asarray(z) for z in (x, a, b, c)), chunk=chunk)
    got, _ = decomposed(*(_t(z) for z in (x, a, b, c)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(STRONG_TOL if strong else TOL))


@pytest.mark.parametrize("t", [150, 64])
def test_decomposition_at_chunk_64_under_strong_decay_matches_the_token_oracle(t):
    """a_log in [-40, 0] at the serving chunk: L falls past -10^3 within a
    chunk; the oracle takes one exp a step and no prefix sum."""
    x, a, b, c, h0 = _inputs(2, t, 16, 32, seed=5 + t, strong=True)
    assert float(a[:, :64].sum(axis=1).max()) < -1000.0
    wy, wh = jref.ssd(*(jnp.asarray(z) for z in (x, a, b, c)), h0=jnp.asarray(h0))
    gy, gh = decomposed(*(_t(z) for z in (x, a, b, c)), h0=_t(h0), chunk=64)
    assert torch.isfinite(gy).all() and torch.isfinite(gh).all()
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)


@pytest.mark.parametrize("t,chunk", [(128, 64), (37, 8), (1, 64)])
def test_decomposition_matches_the_plain_version(t, chunk):
    """The plain version CPU tensors run (a copy of ssd_chunked's body with
    L in f64), from a state, in bf16 x/b/c as the full-width model feeds the
    kernel: c b^T's products are exact in f32 there, as on mma.sync."""
    x, a, b, c, h0 = _inputs(4, t, 32, 32, seed=t)
    bf = [_t(z).to(torch.bfloat16) for z in (x, b, c)]
    gy, gh = decomposed(bf[0], _t(a), bf[1], bf[2], h0=_t(h0), chunk=chunk)
    wy, wh = mamba2.reference(bf[0], _t(a), bf[1], bf[2], h0=_t(h0), chunk=chunk)
    assert gy.dtype == torch.bfloat16
    torch.testing.assert_close(gy.float(), wy.float(), rtol=1.6e-2, atol=1.6e-2)
    torch.testing.assert_close(gh, wh, **TOL)


def test_workspaces_hold_a_state_a_chunk():
    assert mamba2.DEVICE_LAUNCHES == 3
    assert mamba2.workspace_shapes(256, 128, 64, 64, 64) == ((256, 2, 64, 64), (256, 2))
    assert mamba2.workspace_shapes(64, 4096, 64, 64, 64) == ((64, 64, 64, 64), (64, 64))
    assert mamba2.workspace_shapes(32, 10, 16, 16, 8) == ((32, 2, 16, 16), (32, 2))
    assert mamba2.workspace_shapes(2, 37, 24, 40, 64) == ((2, 1, 24, 40), (2, 1))
