"""The GEMM plan (`repro_torch.kernels.gemm.plan`): route, tile and K split.

The plan decides from the shape, the dtype and the addresses alone which
kernel runs a GEMM: the bf16 tensor-core one (`csrc/gemm_sm90.cu`,
"wgmma"), the f64 one (`csrc/gemm_f64.cu`, "dmma"), the f32 CUDA-core one
on a shared-memory ring (`csrc/gemm_f32*.cu`, "ffma_sm90", its feed in
`Plan.stage` where it copies operands first) or the first CUDA-core one
(`csrc/gemm.cu`, "ffma").  These tests hold it to its contract on the CPU:
every served projection shape routes to "wgmma" in place; every other
dense bf16 call (odd K or N, unaligned) to "wgmma" on staged operands
(rows copied to 16-byte strides first, no K split); `gemm.tma_rows` pads
only what TMA cannot address; every dense f64 call to "dmma", with
16-byte copies for even K and N on 16-byte boundaries and 8-byte ones
otherwise; every dense f32 call with K > 0 to "ffma_sm90", in place where
K and N are multiples of 4 on 16-byte boundaries, else on staged operands;
packed f32 whose A and int8 rows TMA can address to "ffma_sm90"; packed
bf16 "kn" with a scale block of whole k-steps and int8 rows TMA can address
to "wgmma" (A staged where it is off 16 bytes); every packed f64 call to
"dmma" with the widest copy its int8 rows allow; a K of 0 and the packed
forms no other route takes (bf16 "kn" TMA or the k-step cannot take, "nk"
with scales along K, f32 rows TMA cannot address) to "ffma";
the K slices cover K exactly in whole k-steps; the grid fills at least
half the card or K is split.

The split-K path sums f32 partials of each K slice in slice order and then
applies the epilogue.  `_split_k_emulation` does that on the CPU, and is
held to the JAX package's `ops.bgemm` (Pallas interpret mode, as
tests/test_torch_kernels.py runs it) and to the port's plain version.
Tolerances: f32 rtol = atol = 1e-5 (only the summation order differs);
bf16 one bf16 rounding step of the output (rtol = atol = 2e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import quant
from repro_torch.core.epilogue import make
from repro_torch.kernels import bgemm as tbgemm
from repro_torch.kernels import gemm

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# every bf16 prefill projection of the served models at 4 x 128 prompt
# tokens: (what, K, N, gate)
SERVED = [
    ("stablelm q/k/v +bias, wo +residual", 2048, 2048, False),
    ("stablelm gate+up silu-gate", 2048, 5632, True),
    ("stablelm down +residual", 5632, 2048, False),
    ("rwkv r/k/v/g/o", 2048, 2048, False),
    ("rwkv channel-mix key", 2048, 7168, False),
    ("rwkv channel-mix value", 7168, 2048, False),
    ("rwkv decay LoRA down", 2048, 64, False),
    ("rwkv decay LoRA up", 64, 2048, False),
    ("zamba2 in_proj", 2048, 8384, False),
    ("zamba2 out_proj", 4096, 2048, False),
    ("zamba2 shared q/k/v/o", 2048, 2048, False),
    ("zamba2 shared up gelu", 2048, 8192, False),
    ("zamba2 shared down", 8192, 2048, False),
]


@pytest.mark.parametrize("what,k,n,gate", SERVED)
@pytest.mark.parametrize("rows", [4 * 128, 4 * 127, 4 * 160])
def test_every_served_projection_routes_to_wgmma(what, k, n, gate, rows):
    p = gemm.plan(rows, k, n, BF16, gate=gate)
    assert p.route == "wgmma" and not p.stage, what
    assert p.tile in (gemm.GATE_TILES if gate else gemm.TC_TILES)
    assert 1 <= p.splits <= -(-k // gemm.BK)


@pytest.mark.parametrize("k,n,gate", [(2048, 2048, False), (2048, 5632, True), (5632, 2048, False)])
def test_serving_int8_layout_routes_to_wgmma(k, n, gate):
    """`serve --quantize int8` packs every projection output-major with one
    scale block across K (`layers.quantize_weights`' spec)."""
    w = torch.randn(64, 128)
    qw = quant.quantize(w, quant.QuantSpec(block_m=64, block_n=None, transpose=True))
    assert gemm.packed_layout(qw) == "nk"
    assert gemm.plan(512, k, n, BF16, gate=gate, packed_layout="nk").route == "wgmma"


@pytest.mark.parametrize("m,k,n,dtype,gate,layout,aligned,block", [
    (512, 0, 2048, F32, False, None, True, None),          # f32, K = 0: the epilogue alone
    (512, 2048, 2040, F32, False, "kn", True, None),       # f32 A, int8 rows of 2040 bytes
    (512, 2056, 2048, F32, False, "nk", True, None),       # f32 A, stored rows of 2056 bytes
    (512, 2056, 2048, F32, True, "nk-kblocks", True, None),
    (4095, 4097, 4093, F32, False, "kn", True, None),      # the BLAS ragged int8 case
    (512, 2047, 2048, F32, False, "kn", True, None),       # odd K: A's rows off 16 bytes
    (512, 2046, 2048, F32, True, "kn", True, None),        # K % 4, the gate
    (1, 3, 5, F32, False, "kn", True, None),               # f32, tiny odd packed shape
    (512, 2048, 2056, F32, True, "kn", True, None),        # N % 16, the gate
    (512, 2048, 2048, F32, True, "nk-kblocks", False, None),  # f32 A, packed, unaligned
    (512, 2048, 2048, F32, False, "nk", False, None),
    (512, 2048, 2048, F32, False, "kn", False, None),      # f32 A, packed B, unaligned
    (512, 0, 2048, F64, False, None, True, None),          # K = 0: the epilogue alone
    (512, 0, 2048, F64, False, "kn", True, (64, 2048)),
    (512, 0, 2048, BF16, False, None, True, None),
    (512, 0, 2048, F32, True, None, True, None),
    (512, 2048, 2048, BF16, False, "nk", False, None),     # int8 "nk" off 16 bytes
    (512, 2048, 2048, BF16, False, "nk-kblocks", True, None),  # scales vary along K
    (512, 2056, 2048, BF16, False, "nk", True, None),      # int8 K % 16
    (0, 2048, 2048, BF16, False, None, True, None),        # nothing to compute
    # bf16 "kn" the tensor cores cannot take: a scale block ending inside a
    # 64-row k-step, int8 rows TMA cannot address (N % 16, B off 16 bytes)
    (512, 2016, 2048, BF16, False, "kn", True, (48, 2048)),
    (512, 2016, 2048, BF16, True, "kn", True, (96, 2048)),
    (512, 2048, 2056, BF16, False, "kn", True, (64, 2056)),
    (512, 2048, 2040, BF16, True, "kn", True, (64, 1020)),
    (512, 2048, 2048, BF16, False, "kn", False, (64, 2048)),
    (4095, 4096, 2064, BF16, True, "kn", False, (64, 2064)),
    (512, 2048, 2048, BF16, True, "nk-kblocks", True, (64, 64)),
])
def test_the_rest_routes_to_ffma(m, k, n, dtype, gate, layout, aligned, block):
    """aligned: every operand on 16 bytes, the packed B's values too."""
    p = gemm.plan(m, k, n, dtype, gate=gate, packed_layout=layout, block=block, aligned=aligned,
                  b_aligned=aligned)
    assert p == gemm.Plan("ffma", gemm.FFMA_TILE[gate], 1)


@pytest.mark.parametrize("m,k,n,gate,block,aligned", [
    (512, 2048, 2048, True, (64, 2048), True),      # int8 stored (K, N), the gate
    (512, 2048, 2048, False, (64, 2048), True),     # int8 stored (K, N)
    (8192, 8192, 8192, False, (64, 8192), True),    # the BLAS cell, quantize(w)'s default
    (4095, 4096, 2064, True, (64, 2064), True),     # ragged M, the gate
    (4095, 4096, 2064, False, (64, 2064), True),
    (1024, 1024, 1024, False, (64, 16), True),      # scales that vary along N
    (1024, 1024, 1024, True, (128, 64), True),      # two k-steps a scale row
    (512, 2048, 2048, False, (64, 2048), False),    # A off 16 bytes: staged
    (130, 192, 80, False, (64, 80), True),
    (1, 64, 16, True, (64, 16), False)])
def test_packed_bf16_kn_routes_to_wgmma(m, k, n, gate, block, aligned):
    """bf16 A against int8 stored (K, N) whose scale block spans whole
    k-steps (qa % 64 == 0) and whose rows TMA can address (N % 16 == 0, the
    values on 16 bytes): the tensor cores, A staged where it is off 16 bytes,
    on the largest of PACKED_TILES (the gate's PACKED_GATE_TILES) whose
    grid fills FILL of the card, else the smallest; K never split."""
    p = gemm.plan(m, k, n, BF16, gate=gate, packed_layout="kn", block=block, aligned=aligned,
                  b_aligned=True)
    tiles = gemm.PACKED_GATE_TILES if gate else gemm.PACKED_TILES
    assert (p.route, p.splits, p.copy, p.stage) == ("wgmma", 1, 0, not aligned)
    assert p.tile in tiles
    larger = tiles[:tiles.index(p.tile)]
    assert all(-(-m // b0) * -(-n // b1) < gemm.FILL * 132 for b0, b1 in larger)
    assert -(-m // p.tile[0]) * -(-n // p.tile[1]) >= gemm.FILL * 132 or p.tile == tiles[-1]
    if m == k == n == 8192:
        assert p.tile[0] * p.tile[1] > 64 * 64


@pytest.mark.parametrize("m,k,n,gate,layout,b_aligned,fits", [
    (512, 2048, 2048, False, "kn", True, 16),       # f64 activations, packed B
    (512, 2048, 2048, True, "nk", True, 16),
    (512, 2048, 2048, False, "nk-kblocks", True, 16),
    (8192, 8192, 8192, False, "kn", True, 16),      # the BLAS cells
    (8192, 8192, 8192, False, "nk", True, 16),
    (512, 2048, 2056, False, "kn", True, 8),        # rows of 2056 bytes
    (512, 2056, 2048, True, "nk", True, 8),
    (512, 2048, 2052, True, "kn", True, 4),         # rows of 2052 bytes
    (300, 2052, 64, False, "nk-kblocks", True, 4),
    (4095, 4097, 4093, False, "kn", True, 1),       # the BLAS ragged case
    (130, 37, 67, True, "nk", True, 1),
    (512, 2048, 2048, False, "kn", False, 1),       # the values off 16 bytes
    (1, 1, 1, False, "nk", True, 1)])
def test_packed_f64_routes_to_dmma_with_its_copy_width(m, k, n, gate, layout, b_aligned, fits):
    """f64 A against a packed B, every layout: the f64 tensor cores on the
    dense plan's tile (with the gate 64 x 64), every copy 16 bytes.  `fits` is the widest copy the
    stored int8 rows (N bytes "kn", K bytes "nk") take where they lie (1:
    none, or the values off 16 bytes); where it is under 16, K is odd or A
    is off 16 bytes, the operands are first staged into rows padded to 16
    bytes."""
    for aligned in (True, False):
        p = gemm.plan(m, k, n, F64, gate=gate, packed_layout=layout, block=(1, 1),
                      aligned=aligned and b_aligned, b_aligned=b_aligned)
        in_place = fits == 16 and k % 2 == 0 and aligned
        assert (p.route, p.copy, p.splits, p.stage) == ("dmma", 16, 1, not in_place)
        assert p.tile == (gemm.DMMA_Q8_GATE_TILES[0] if gate
                          else gemm.plan(m, k, n, F64, gate=gate).tile)


@pytest.mark.parametrize("m,k,n,gate,aligned", [
    (4 * 127, 2047, 2001, False, True),  # the ragged bgemm case
    (4095, 4097, 4093, False, True),     # the BLAS odd case
    (512, 2048, 2001, True, True),       # N % 8, the gate
    (512, 2044, 2048, False, True),      # K % 8
    (512, 2048, 2048, False, False),     # a base address off 16 bytes
    (512, 2048, 5632, True, False),      # the served gate+up shape, off 16 bytes
    (1, 1, 1, False, True),
    (8192, 8191, 8192, False, True)])
def test_odd_or_unaligned_dense_bf16_routes_to_mma(m, k, n, gate, aligned):
    """Every dense bf16 call TMA cannot address in place runs the tensor
    cores on staged operands (the route that replaced the mma.sync kernel),
    never the CUDA cores: on the largest of the route's tiles whose grid
    fills FILL of the card, else the smallest; no K split."""
    p = gemm.plan(m, k, n, BF16, gate=gate, aligned=aligned)
    tiles = gemm.GATE_TILES if gate else gemm.TC_TILES
    assert p.route == "wgmma" and p.stage and p.splits == 1 and p.tile in tiles
    assert p.copy == 0
    larger = tiles[:tiles.index(p.tile)]
    assert all(-(-m // b0) * -(-n // b1) < gemm.FILL * 132 for b0, b1 in larger)
    assert -(-m // p.tile[0]) * -(-n // p.tile[1]) >= gemm.FILL * 132 or p.tile == tiles[-1]


@pytest.mark.parametrize("m,k,n,gate,aligned,copy", [
    (512, 2047, 2048, False, True, 8),    # odd K
    (512, 2048, 2047, True, True, 8),     # odd N, the gate
    (4095, 4097, 4093, False, True, 8),   # the BLAS odd case
    (512, 2048, 2048, False, False, 8),   # a base address off 16 bytes
    (1, 1, 1, False, True, 8),
    (4095, 4098, 4094, False, True, 16),  # the BLAS even ragged neighbour
    (8192, 8192, 8192, False, True, 16),
    (512, 2048, 5632, True, True, 16)])
def test_every_dense_f64_routes_to_dmma_with_its_copy_width(m, k, n, gate, aligned, copy):
    """Dense f64 always runs the f64 tensor cores; the plan records 16-byte
    copies where K and N are even and the bases on 16 bytes, else 8-byte
    copies (one double), on the same tiles."""
    p = gemm.plan(m, k, n, F64, gate=gate, aligned=aligned)
    assert p.route == "dmma" and p.copy == copy and p.splits == 1
    assert p.tile == gemm.plan(m, k + k % 2, n + n % 2, F64, gate=gate).tile


@pytest.mark.parametrize("m,k,n,gate", [(512, 2048, 2048, False),     # was an "ffma" case
                                        (8192, 8192, 8192, False),    # the BLAS cell
                                        (2048, 128, 2048, False),    # zamba2's LoRA merge
                                        (4095, 4096, 4092, False),   # aligned ragged
                                        (512, 2048, 5632, True),     # the gate
                                        (28, 64, 64, False),         # f32 smoke prefill
                                        (20, 8, 64, False),          # smoke LoRA, K = 8
                                        (1, 4, 4, True),
                                        (300, 4, 4, False)])
def test_aligned_f32_routes_to_ffma_sm90(m, k, n, gate):
    """Dense f32 with K and N multiples of 4 on 16-byte boundaries: the
    CUDA-core kernel on the TMA ring, with the gate, on the largest tile
    whose grid fills FILL of the card, else the smallest; no K split."""
    p = gemm.plan(m, k, n, F32, gate=gate)
    tiles = gemm.FFMA_SM90_GATE_TILES if gate else gemm.FFMA_SM90_TILES
    assert p.route == "ffma_sm90" and p.splits == 1 and p.tile in tiles
    larger = tiles[:tiles.index(p.tile)]
    assert all(-(-m // b0) * -(-n // b1) < gemm.FILL * 132 for b0, b1 in larger)
    assert -(-m // p.tile[0]) * -(-n // p.tile[1]) >= gemm.FILL * 132 or p.tile == tiles[-1]


def test_f32_plan_takes_the_large_tile_where_it_fills_the_card():
    """8192^3 and the LoRA merge (256 tiles of 128 x 128) take 128 x 128;
    512 prefill rows at N = 2048 take 128 tiles of 128 x 64; the f32 smoke
    shapes take 64 x 64; the gate at 512 x 5632 takes 128 x 64."""
    assert gemm.plan(8192, 8192, 8192, F32) == gemm.Plan("ffma_sm90", (128, 128), 1)
    assert gemm.plan(2048, 128, 2048, F32) == gemm.Plan("ffma_sm90", (128, 128), 1)
    assert gemm.plan(512, 2048, 2048, F32) == gemm.Plan("ffma_sm90", (128, 64), 1)
    assert gemm.plan(28, 64, 296, F32) == gemm.Plan("ffma_sm90", (64, 64), 1)
    assert gemm.plan(512, 2048, 5632, F32, gate=True) == gemm.Plan("ffma_sm90", (128, 64), 1)


# (m, k, n, gate, aligned): odd K, K % 4, N % 4 with the gate, the BLAS
# ragged case, a base off 16 bytes, a tiny odd shape, odd N with the gate,
# the gate off 16 bytes, K of 1, the served gate+up shape off 16 bytes
@pytest.mark.parametrize("m,k,n,gate,aligned", [
    (512, 2047, 2048, False, True),
    (512, 2046, 2048, False, True),
    (512, 2048, 2046, True, True),
    (4095, 4097, 4093, False, True),
    (512, 2048, 2048, False, False),
    (1, 3, 5, False, True),
    (512, 2048, 2047, True, True),
    (512, 2048, 2048, True, False),
    (300, 1, 7, False, True),
    (512, 2048, 5632, True, False),
    (508, 2047, 2001, False, True)])
def test_dense_f32_tma_cannot_address_routes_to_ffma_sm90_staged(m, k, n, gate, aligned):
    """Every dense f32 call TMA cannot address in place runs the f32 ring on
    staged operands (rows copied to 16-byte strides first: faster than an
    element-copy feed of the ring), on the tile the aligned shape takes, no
    K split."""
    p = gemm.plan(m, k, n, F32, gate=gate, aligned=aligned)
    tiles = gemm.FFMA_SM90_GATE_TILES if gate else gemm.FFMA_SM90_TILES
    assert (p.route, p.copy, p.splits, p.stage) == ("ffma_sm90", 0, 1, True)
    assert p.tile in tiles and p.tile == gemm.plan(m, k + -k % 4, n + -n % 4, F32, gate=gate).tile


@pytest.mark.parametrize("m,k,n,gate,layout", [
    (512, 2048, 2048, False, "kn"),         # f32 activations, packed B
    (512, 2048, 2048, True, "nk-kblocks"),  # scales along K, the gate
    (512, 2048, 2048, True, "nk"),          # the serving layout under f32 A
    (8192, 8192, 8192, False, "kn"),        # the BLAS int8 cells
    (8192, 8192, 8192, False, "nk"),
    (28, 64, 64, False, "nk"),              # the f32 int8 smoke serve's prefill
    (513, 2052, 2048, True, "kn"),          # ragged M, K % 16 (A's rows of 16 bytes)
    (1, 16, 16, False, "nk")])
def test_packed_f32_routes_to_ffma_sm90(m, k, n, gate, layout):
    """f32 A against int8 B whose rows TMA can address (K % 4 == 0; the
    stored int8 rows a multiple of 16 bytes): the f32 ring, the int8
    dequantized in its staging, on the dense plan's tile."""
    p = gemm.plan(m, k, n, F32, gate=gate, packed_layout=layout)
    assert (p.route, p.copy, p.splits, p.stage) == ("ffma_sm90", 0, 1, False)
    assert p.tile == gemm.plan(m, k, n, F32, gate=gate).tile


@pytest.mark.parametrize("m,k,n,gate", [(8192, 8192, 8192, False), (4095, 4098, 4094, False),
                                        (512, 2048, 5632, True), (1, 2, 2, False),
                                        (130, 36, 66, True), (300, 2, 2, False)])
def test_aligned_f64_routes_to_dmma(m, k, n, gate):
    """Dense f64 with even K and N on 16-byte boundaries: the f64 tensor
    cores, with the gate, on the largest tile whose grid fills FILL of the
    card, else the smallest; no K split."""
    p = gemm.plan(m, k, n, F64, gate=gate)
    tiles = gemm.DMMA_GATE_TILES if gate else gemm.DMMA_TILES
    assert p.route == "dmma" and p.splits == 1 and p.tile in tiles and p.copy == 16
    larger = tiles[:tiles.index(p.tile)]
    assert all(-(-m // b0) * -(-n // b1) < gemm.FILL * 132 for b0, b1 in larger)
    assert -(-m // p.tile[0]) * -(-n // p.tile[1]) >= gemm.FILL * 132 or p.tile == tiles[-1]


@pytest.mark.parametrize("rows,cols,shift,padded", [
    (5, 37, 0, 40),    # odd width: rows padded to 8 elements
    (3, 64, 1, 64),    # whole 16-byte rows, base 2 bytes off: copied, not padded
    (4, 2001, 0, 2008),
    (7, 8, 0, None),   # addressable in place
    (2, 128, 8, None)])
def test_tma_rows_pads_only_what_tma_cannot_address(rows, cols, shift, padded):
    """gemm.tma_rows returns an operand TMA can address as it is, and else a
    copy whose rows start 16 bytes apart and hold the operand's values in
    their first `cols` elements (the padding is never read)."""
    buf = torch.arange(rows * cols + shift, dtype=torch.float32).to(BF16)
    x = buf[shift:].view(rows, cols)
    got, ld = gemm.tma_rows(x)
    if padded is None:
        assert got is x and ld == cols
        return
    assert ld == padded and got.shape == (rows, padded) and got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :cols], x)


def test_packed_layouts():
    w = torch.randn(128, 64)  # logical (K, N)
    spec = dict(block_m=16, block_n=None)
    assert gemm.packed_layout(quant.quantize(w, quant.QuantSpec(**spec))) == "kn"
    assert gemm.packed_layout(quant.quantize(w, quant.QuantSpec(**spec, transpose=True))) == "nk"
    kblocks = quant.quantize(w, quant.QuantSpec(block_m=16, block_n=32, transpose=True))
    assert gemm.packed_layout(kblocks) == "nk-kblocks"


# (k, splits) with at least one k-step a slice, as the plan splits
K_SPLITS = [(k, s) for k in (1, 8, 63, 64, 65, 72, 1000, 1024, 2048, 2047 * 8, 8192)
            for s in (1, 2, 3, 7, 16, 32) if s <= -(-k // 64)]


@pytest.mark.parametrize("k,splits", K_SPLITS)
def test_k_slices_cover_k_in_whole_steps(k, splits):
    cuts = gemm.Plan("wgmma", (64, 64), splits).k_slices(k)
    assert len(cuts) == splits
    assert cuts[0][0] == 0 and cuts[-1][1] == k
    for (a0, a1), (b0, _) in zip(cuts, cuts[1:]):
        assert a1 == b0
    for k0, k1 in cuts:
        assert k0 < k1 and k0 % gemm.BK == 0 and (k1 % gemm.BK == 0 or k1 == k)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", [1, 64, 4 * 127, 512, 4096, 8192])
@pytest.mark.parametrize("k,n", [(2048, 64), (2048, 2048), (64, 2048), (8192, 8), (1024, 8192),
                                 (8192, 8192), (512, 512), (4096, 264)])
def test_grid_fills_half_the_card_or_splits_k(sms, m, k, n):
    """The largest tile whose grid fills 90% of the SMs, else the smallest;
    at least half a wave of blocks, or, where the tiles alone leave more than
    half the SMs idle and K >= 1024, K split (at least 2 slices, at most one
    per 2 k-steps) into about half a wave."""
    p = gemm.plan(m, k, n, BF16, sms=sms)
    bm, bn = p.tile
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // gemm.BK)
    larger = gemm.TC_TILES[:gemm.TC_TILES.index(p.tile)]
    assert all(-(-m // b0) * -(-n // b1) < gemm.FILL * sms for b0, b1 in larger)
    assert tiles >= gemm.FILL * sms or p.tile == gemm.TC_TILES[-1]
    if tiles >= sms / 2:
        assert p.splits == 1
    elif k >= gemm.SPLIT_MIN_K:
        assert 2 <= p.splits <= max(2, steps // 2)
        assert tiles * p.splits >= sms / 2 or p.splits == steps // 2
        assert tiles * p.splits <= 1.5 * sms
    else:
        assert p.splits == 1


def test_plan_prefers_one_full_wave_of_large_tiles():
    """The big GEMMs take the largest tile; q/k/v's 512 rows take 128 tiles
    of 128 x 64 rather than 64 tiles of 128 x 128 (half the card idle); the
    gate takes 128 x 64; rwkv's 2048 -> 64 takes 8 tiles of 64 x 64 and 9
    K slices."""
    assert gemm.plan(8192, 8192, 8192, BF16) == gemm.Plan("wgmma", (128, 128), 1)
    assert gemm.plan(512, 2048, 8384, BF16) == gemm.Plan("wgmma", (128, 128), 1)
    assert gemm.plan(512, 2048, 2048, BF16) == gemm.Plan("wgmma", (128, 64), 1)
    assert gemm.plan(512, 2048, 5632, BF16, gate=True) == gemm.Plan("wgmma", (128, 64), 1)
    assert gemm.plan(512, 2048, 64, BF16) == gemm.Plan("wgmma", (64, 64), 9)


def _split_k_emulation(a, b, p, *, b2=None, bias=None, residual=None, activation=None):
    """The split-K path on the CPU: f32 partials of each K slice, summed in
    slice order, then the epilogue in f32, rounded once to a's dtype."""
    af = a.float()
    acc = acc2 = None
    for k0, k1 in p.k_slices(a.shape[-1]):
        part = af[..., k0:k1] @ b[k0:k1].float()
        acc = part if acc is None else acc + part
        if b2 is not None:
            part2 = af[..., k0:k1] @ b2[k0:k1].float()
            acc2 = part2 if acc2 is None else acc2 + part2
    epi = make(activation, bias=bias, gate=b2, residual=residual)
    return epi.apply(acc, acc2=acc2, bias=bias, residual=residual).to(a.dtype)


def _pair(x, dtype):
    x = np.asarray(x, np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,bias,gate,res", [(None, False, False, False),
                                               ("silu", True, True, False),
                                               ("gelu", True, False, True)])
def test_split_k_emulation_matches_pallas_and_plain(dtype, act, bias, gate, res):
    """(2, 32, 1024) @ (1024, 72): one 64 x 128 tile, so the plan splits K
    into 8 slices of 2 k-steps."""
    batch, m, k, n = 2, 32, 1024, 72
    p = gemm.plan(batch * m, k, n, BF16, gate=gate)
    assert p.route == "wgmma" and p.splits == 8
    rng = np.random.default_rng(17)
    a_j, a_t = _pair(rng.standard_normal((batch, m, k)), dtype)
    b_j, b_t = _pair(rng.standard_normal((k, n)) * k ** -0.5, dtype)
    kj, kt = {}, {}
    if gate:
        kj["b2"], kt["b2"] = _pair(rng.standard_normal((k, n)) * k ** -0.5, dtype)
    if bias:
        kj["bias"], kt["bias"] = _pair(rng.standard_normal(n), dtype)
    if res:
        kj["residual"], kt["residual"] = _pair(rng.standard_normal((batch, m, n)), dtype)
    kj["activation"] = kt["activation"] = act
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    got = _split_k_emulation(a_t, b_t, p, **kt)
    want = jops.bgemm(a_j, b_j, out_dtype=a_j.dtype, **kj)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    plain = tbgemm.reference(a_t, b_t, **kt)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), **tol)
