"""The WKV6 kernel's decomposition (csrc/rwkv6.cu), modelled in PyTorch on
the CPU and held against the JAX package.

The kernel runs the chunked recurrence as three launches: every chunk's
state increment dS_n and decay d_n = exp(L_C) at once, then the carried
state S_n = d_n * S_{n-1} + dS_n element by element across the chunks, then
every chunk's outputs y = (r * exp(Lprev)) S_{n-1} + A v + diag v at once,
with the log-decay cumsum summed by quarters of the chunk as its threads
sum it.  `decomposed` below repeats that arithmetic in plain PyTorch (f32)
and is held against `repro.models.rwkv.wkv6_chunked` (y and the final
state, from a state and from zeros) and against the Pallas kernel
`repro.kernels.ops.rwkv6` in interpret mode (y from zeros), on seeded numpy
inputs: ragged T, chunk 8 and 32, and strong decay near the -20 clamp.

Tolerance: rtol = atol = 1e-5 against the f32 references, as the plain
version's own tests (tests/test_torch_rwkv.py); the quarters' cumsum and
the products differ from the references' summation order only.  Under
strong decay (|L| up to 640 within a chunk) an exponent of a few units is
the difference of two sums of that size, so its f32 rounding (640 * 2^-24
~ 4e-5) sets the tolerance there: rtol = atol = 1e-4, chip_smoke's f32 gate.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.models import rwkv as jrwkv
from repro_torch.kernels import rwkv6

TOL = dict(rtol=1e-5, atol=1e-5)
STRONG_TOL = dict(rtol=1e-4, atol=1e-4)
QUARTERS = 4  # the kernel's scan: threads per channel (SEGS in csrc/rwkv6.cu)


def _quarter_cumsum(w):
    """Inclusive cumsum over dim -2 as the kernel sums it: each quarter of
    ceil(C / 4) rows in order, then the earlier quarters' totals added in
    order."""
    c = w.shape[-2]
    rows = -(-c // QUARTERS)
    parts, totals = [], []
    for q in range(QUARTERS):
        seg = w[..., q * rows:min(c, (q + 1) * rows), :]
        if seg.shape[-2] == 0:
            continue
        run, acc = torch.zeros_like(seg[..., 0, :]), []
        for i in range(seg.shape[-2]):
            run = run + seg[..., i, :]
            acc.append(run)
        part = torch.stack(acc, -2)
        if totals:
            off = totals[0]
            for tot in totals[1:]:
                off = off + tot
            part = part + off[..., None, :]
        totals.append(run)
        parts.append(part)
    return torch.cat(parts, -2)


def decomposed(r, k, v, w_log, u, s0=None, chunk: int = 32):
    """y (r's dtype) and s_fin (f32) by the kernel's three stages."""
    bh, t, kk = r.shape
    vv = v.shape[-1]
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        r, k, v, w_log = (F.pad(z, (0, 0, 0, pad)) for z in (r, k, v, w_log))
    nc = r.shape[1] // c
    rs, ks, vs, ws = (z.reshape(bh, nc, c, -1).float() for z in (r, k, v, w_log))
    L = _quarter_cumsum(ws)                                   # (BH, n, C, K)
    lc = L[:, :, -1]                                          # L_C (BH, n, K)
    # 1. states: every chunk's increment and decay at once
    dec = torch.exp(lc)
    ds = torch.einsum("bnck,bncv->bnkv", ks * torch.exp(lc[:, :, None] - L), vs)
    # 2. the carried state, one multiply-add a state element a chunk
    s = torch.zeros((bh, kk, vv)) if s0 is None else s0.float().clone()
    entering = []
    for n in range(nc):
        entering.append(s)
        s = dec[:, n, :, None] * s + ds[:, n]
    sprev = torch.stack(entering, 1)                          # (BH, n, K, V)
    # 3. outputs: every chunk at once, A pairwise (never factored)
    lp = L - ws
    e = lp[:, :, :, None, :] - L[:, :, None, :, :]            # (BH, n, C, C, K)
    a = (rs[:, :, :, None, :] * ks[:, :, None, :, :]
         * torch.exp(torch.clamp(e, max=0.0))).sum(-1) * torch.tril(torch.ones(c, c), -1)
    diag = (rs * u[:, None, None, :] * ks).sum(-1, keepdim=True)
    inter = torch.einsum("bnck,bnkv->bncv", rs * torch.exp(lp), sprev)
    intra = torch.einsum("bncs,bnsv->bncv", a, vs)
    y = (inter + intra) + diag * vs
    return y.reshape(bh, nc * c, vv)[:, :t].to(r.dtype), s


def _inputs(bh, t, kk, seed, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, t, kk)).astype(np.float32) * 0.5 for _ in range(3))
    if strong:  # the log-decay itself in [-20, -15], the clamp's edge
        w = (-15.0 - 5.0 * rng.random((bh, t, kk))).astype(np.float32)
    else:
        w = -np.exp(rng.standard_normal((bh, t, kk))).astype(np.float32)
    u = (rng.standard_normal((bh, kk)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((bh, kk, kk)).astype(np.float32)
    return r, k, v, w, u, s0


CASES = [  # (T, chunk, strong decay)
    (64, 32, False), (37, 32, False), (21, 8, False), (5, 8, False), (70, 32, True),
    (19, 8, True),
]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("t,chunk,strong", CASES)
def test_decomposition_matches_wkv6_chunked(t, chunk, strong, with_s0):
    r, k, v, w, u, s0 = _inputs(3, t, 16, seed=t + chunk, strong=strong)
    s0 = s0 if with_s0 else None
    wy, ws = jrwkv.wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                s0=None if s0 is None else jnp.asarray(s0), chunk=chunk)
    gy, gs = decomposed(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                        s0=None if s0 is None else torch.from_numpy(s0), chunk=chunk)
    tol = STRONG_TOL if strong else TOL
    assert torch.isfinite(gy).all() and torch.isfinite(gs).all()
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **tol)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **tol)


@pytest.mark.parametrize("t,chunk,strong", CASES)
def test_decomposition_matches_the_pallas_kernel(t, chunk, strong):
    r, k, v, w, u, _ = _inputs(2, t, 16, seed=3 * t + chunk, strong=strong)
    want = jops.rwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk)
    got, _ = decomposed(*(torch.from_numpy(a) for a in (r, k, v, w, u)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(STRONG_TOL if strong else TOL))


@pytest.mark.parametrize("t,chunk", [(64, 32), (37, 8), (1, 32)])
def test_decomposition_matches_the_plain_version(t, chunk):
    """The plain version CPU tensors run (a copy of wkv6_chunked's body),
    from a state, in bf16 r/k/v as the full-width model feeds the kernel."""
    r, k, v, w, u, s0 = _inputs(4, t, 32, seed=t)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    f32 = [torch.from_numpy(a) for a in (w, u, s0)]
    gy, gs = decomposed(*bf, *f32[:2], s0=f32[2], chunk=chunk)
    wy, ws = rwkv6.reference(*bf, *f32[:2], s0=f32[2], chunk=chunk)
    assert gy.dtype == torch.bfloat16
    torch.testing.assert_close(gy.float(), wy.float(), rtol=1.6e-2, atol=1.6e-2)
    torch.testing.assert_close(gs, ws, **TOL)


def test_workspaces_hold_a_state_a_chunk():
    assert rwkv6.workspace_shapes(32, 4096, 64, 64, 32) == ((32, 128, 64, 64), (32, 128, 64))
    assert rwkv6.workspace_shapes(3, 10, 16, 16, 32) == ((3, 1, 16, 16), (3, 1, 16))
    assert rwkv6.workspace_shapes(2, 37, 16, 8, 8) == ((2, 5, 16, 8), (2, 5, 16))
