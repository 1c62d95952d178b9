"""`kernels.bgemv.plan_int8`: the body and K split of the packed int8 GEMV
(csrc/qgemv.cu), and plain models of the kernel's arithmetic, on the CPU.

The plan is a pure function of the shapes: bf16 x under one scale a row
(the serving spec) runs the tensor-core body ("tc": a block owns 16 rows
and its 8 warps share the block's K slice), everything else the CUDA-core
body ("ffma": 32 rows, 16 with the gate, x's slice staged in shared
memory); K is cut into slices of a multiple of 16 columns where the row
groups alone leave the card idle or x's slice would not fit.  These tests hold every served
decode shape of `--quantize int8` (stablelm-1.6b, batch 4 and the chunks
larger batches run in), the BLAS gemv at 16384^2 and the ragged shapes
chip_smoke runs to a legal plan; the split's arithmetic (each slice's
partial, summed in split order, scaled once) and the tensor-core body's
permuted k order (each lane's fragments straight from its own 16-byte
loads) to the plain version within f32's tolerance (rtol = atol = 1e-5:
summation order only).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import bgemv

H100_SMS = 132
SERVED = [  # (batch, K, N, gate): stablelm-1.6b's int8 decode projections
    (4, 2048, 2048, False), (4, 2048, 5632, True), (4, 5632, 2048, False),
    (1, 2048, 2048, False), (5, 2048, 5632, True), (9, 5632, 2048, False),
]
BLAS = [(1, 16384, 16384, False)]
RAGGED = [(4, 4097, 4095, False), (1, 4097, 4095, False), (3, 61, 45, True), (2, 50, 33, False)]
DTYPES = [torch.float32, torch.bfloat16, torch.float64]


@pytest.mark.parametrize("row_scale", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,k,n,gate", SERVED + BLAS + RAGGED)
def test_every_shape_gets_a_legal_plan(b, k, n, gate, dtype, row_scale):
    p = bgemv.plan_int8(b, k, n, dtype, gate=gate, row_scale=row_scale)
    want_route = "tc" if dtype == torch.bfloat16 and row_scale and k % 16 == 0 else "ffma"
    assert p.route == want_route and p.rows == bgemv.INT8_ROWS[(p.route, gate)]
    assert p.splits >= 1 and p.cols >= 1
    assert p.splits * p.cols >= k and (p.splits - 1) * p.cols < k
    if p.splits > 1:
        assert p.cols % 16 == 0  # every slice starts on a 16-byte chunk
    assert p.x_bytes(b, dtype) <= bgemv.INT8_MAX_X_BYTES
    slices = p.k_slices(k)
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(slices, slices[1:]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_rows_off_16_bytes_take_the_cuda_cores(dtype):
    """The tensor-core body loads 16 bytes of a row at a time: packed values
    that start off 16 bytes (a view into a larger buffer) plan the CUDA-core
    body, whose element loads take any alignment."""
    p = bgemv.plan_int8(4, 2048, 2048, dtype, aligned=False)
    assert p.route == "ffma" and p.rows == bgemv.INT8_ROWS[("ffma", False)]


@pytest.mark.parametrize("b,k,n,gate", SERVED)
def test_served_shapes_take_the_tensor_cores_and_fill_the_card(b, k, n, gate):
    """bf16 x under the serving spec: the tensor-core body (16 rows a
    block), split only while the launch holds fewer than INT8_BLOCKS_PER_SM
    blocks an SM, each split at least INT8_MIN_COLS columns."""
    p = bgemv.plan_int8(b, k, n, torch.bfloat16, gate=gate, sms=H100_SMS)
    assert p.route == "tc" and p.x_bytes(b, torch.bfloat16) == 0
    assert p.splits == 1 or (p.cols >= bgemv.INT8_MIN_COLS and p.blocks(b, n) <= bgemv.
                             INT8_BLOCKS_PER_SM["tc"] * H100_SMS)


@pytest.mark.parametrize("b,k,n,gate", SERVED)
def test_x_bytes_a_weight_byte(b, k, n, gate):
    """x is read once a block for its rows (x 2 with the gate): bf16 x at
    batch 4 costs 8 bytes a column, against 16 / 32 weight bytes a column
    on the tensor cores and 32 on the CUDA cores (the first design: 2)."""
    nb = min(b, bgemv.BATCH_CHUNK)
    tc = bgemv.plan_int8(b, k, n, torch.bfloat16, gate=gate)
    ffma = bgemv.plan_int8(b, k, n, torch.float32, gate=gate)
    assert nb * 2 / (tc.rows * (2 if gate else 1)) <= 0.5
    assert nb * 2 / (ffma.rows * (2 if gate else 1)) <= 0.25


def test_f64_x_at_16384_takes_k_slices_to_fit():
    """f64 x at K = 16384 is 128 KB: it cannot sit in one block's shared
    memory, so the plan cuts K."""
    p = bgemv.plan_int8(1, 16384, 16384, torch.float64)
    assert p.route == "ffma" and p.splits >= 2
    assert p.x_bytes(1, torch.float64) <= bgemv.INT8_MAX_X_BYTES


def test_plan_depends_on_the_shapes_alone():
    a = bgemv.plan_int8(4, 2048, 2048, torch.bfloat16)
    bgemv.plan_int8.cache_clear()
    assert bgemv.plan_int8(4, 2048, 2048, torch.bfloat16) == a
    # a card with more SMs than row groups gets a K split (and one with as
    # many gets none): the SM count is the plan's only input besides shapes
    assert bgemv.plan_int8(4, 2048, 2048, torch.bfloat16, sms=512).splits > 1
    assert bgemv.plan_int8(4, 2048, 2048, torch.bfloat16, sms=128).splits == 1


def _split_model(qw, x, p):
    """The kernel's arithmetic over the plan's K slices: each slice's raw
    int8 dot (f64 here, so only the split and the scale's place matter),
    summed in split order, the row's one scale applied after the sum."""
    w = qw.values.double()          # (N, K) stored rows
    parts = [x.double()[:, k0:k1] @ w[:, k0:k1].T for k0, k1 in p.k_slices(w.shape[1])]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total * qw.scales.double()[:, 0].repeat_interleave(qw.block[0])[None, :]


def _pack(rng, k, n):
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5)
    return quant.quantize(w, quant.QuantSpec(transpose=True, block_m=32, block_n=None))


@pytest.mark.parametrize("b,k,n", [(4, 2048, 256), (5, 5632, 96), (1, 4097, 64)])
def test_split_partials_in_order_match_the_plain_version(b, k, n):
    rng = np.random.default_rng(k + n)
    qw = _pack(rng, k, n)
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32))
    p = bgemv.plan_int8(b, k, n, torch.float32, sms=H100_SMS)
    for plan in {p, bgemv.Int8Plan(p.route, p.rows, 3, -(-k // 3 // 16) * 16 + 16)}:
        if (plan.splits - 1) * plan.cols >= k:
            continue
        got = _split_model(qw, x, plan)
        torch.testing.assert_close(got.float(), bgemv.reference_int8(qw, x), rtol=1e-5, atol=1e-5)


def _tc_step_model(w, x):
    """One 64-column step of the tensor-core body for a warp's 16 rows and
    8 batch columns, as its lanes hold it: lane (g, q) loaded 16 bytes of
    rows g and g + 8 at columns 16 q and x[g][16 q .. 16 q + 15]; mma j
    takes, from each lane, bytes 4j, 4j + 1 (its k 2q, 2q + 1) and 4j + 2,
    4j + 3 (k 2q + 8, 2q + 9).  Returns the 16 x 8 product the four mma
    steps sum."""
    out = np.zeros((16, 8))
    for j in range(4):
        a = np.zeros((16, 16))
        bm = np.zeros((16, 8))
        for lane in range(32):
            g, q = lane // 4, lane % 4
            cols = [16 * q + 4 * j + e for e in range(4)]  # bytes 4j .. 4j + 3
            for kk, c in zip((2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9), cols):
                a[g, kk], a[g + 8, kk] = w[g, c], w[g + 8, c]
                bm[kk, g] = x[g, c]
        out += a @ bm
    return out


def test_tensor_core_fragments_cover_every_column_once():
    """The permuted k order sums every column of the step exactly once for
    every (row, batch member): the product equals W x."""
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, size=(16, 64)).astype(np.float64)
    x = rng.standard_normal((8, 64))
    np.testing.assert_allclose(_tc_step_model(w, x), w @ x.T, rtol=1e-12, atol=1e-12)
