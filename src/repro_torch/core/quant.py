"""Block-scaled int8 weights and KV cache: the bandwidth lever of the
GEMV-class kernels and of decode attention.

Mirrors the weight and KV halves of `repro.core.quant`.  A weight is packed
as int8 values plus one f32 scale per (block_m, block_n) block of its STORED
layout, symmetric (scale = max|block| / 127, values rounded half to even), so a
decode projection streams 1 byte per weight instead of 2 (bf16) or 4 (f32)
and the kernels dequantize on the fly against their accumulator (W8A16).

Layout: `QuantSpec(transpose=True)` stores a (d, f) weight as (f, d)
"output-major" values, so every output of y = W^T x is one dot over a
contiguous stored row (`csrc/qgemv.cu`).  `QuantizedTensor.shape` stays the
LOGICAL (d, f), so callers are layout-blind.

The arithmetic is the reference's step for step (f32 amax / 127, the inverse
scale through 1 / max(s, 1e-30) masked to 0 for zero scales, round half to
even, clip), so values and scales are bitwise equal to the JAX package's on
the same input, on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INT8_MAX = 127.0


def _fit_block(block: Optional[int], dim: int) -> int:
    """Largest divisor of `dim` that is <= block (None -> dim itself): blocks
    tile the matrix exactly, at the cost of more scales on awkward dims."""
    if block is None or block >= dim:
        return dim
    b = max(1, block)
    while dim % b:
        b -= 1
    return b


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """block_m/block_n: scale-block extents over the STORED rows/cols (None:
    the whole extent).  transpose=True stores values as logical.T."""

    block_m: Optional[int] = 64
    block_n: Optional[int] = None
    dtype: str = "int8"
    transpose: bool = False

    def __post_init__(self):
        if self.dtype != "int8":
            raise ValueError(f"only int8 quantization is supported, got {self.dtype!r}")


@dataclasses.dataclass
class QuantizedTensor:
    """Packed int8 values + per-block f32 scales.

    values: (..., M, N) int8 in STORED orientation (transposed=True means
            stored = logical.T over the last two dims);
    scales: (..., M/qm, N/qn) f32, one per (qm, qn) block of `values`;
    block:  (qm, qn);
    transposed: the layout marker.
    """

    values: torch.Tensor
    scales: torch.Tensor
    block: Tuple[int, int]
    transposed: bool = False

    @property
    def stored_shape(self) -> tuple:
        return tuple(self.values.shape)

    @property
    def shape(self) -> tuple:
        """LOGICAL shape (transpose undone), matching the tensor it replaces."""
        s = tuple(self.values.shape)
        return s[:-2] + (s[-1], s[-2]) if self.transposed else s

    @property
    def ndim(self) -> int:
        return self.values.ndim

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, values=self.values.to(device),
                                   scales=self.scales.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """values * per-block scale in f32, in LOGICAL orientation, cast once
        to `dtype` (the reference's oracle)."""
        out = _expand_scales(self.scales, self.block, self.values.shape) * self.values.float()
        if self.transposed:
            out = out.transpose(-2, -1)
        return out.to(dtype)

    def elementwise_bound(self) -> torch.Tensor:
        """Per-element |x - dequantize| upper bound (scale / 2), LOGICAL
        orientation."""
        b = _expand_scales(self.scales, self.block, self.values.shape) * 0.5
        return b.transpose(-2, -1) if self.transposed else b


def _expand_scales(scales: torch.Tensor, block: Tuple[int, int], shape) -> torch.Tensor:
    """(..., sm, sn) block scales -> (..., m, n) per-element scales."""
    qm, qn = block
    return scales.repeat_interleave(qm, dim=-2).repeat_interleave(qn, dim=-1).reshape(shape)


def dequantize_in(qt: QuantizedTensor, dtype) -> torch.Tensor:
    """values * scales computed IN `dtype`, LOGICAL orientation: the kernels'
    in-accumulator dequantization (`dequant_tile(..., dtype=acc)`).  Equal to
    `dequantize(f32)` for f32; exact products for f64."""
    s = _expand_scales(qt.scales.to(dtype), qt.block, qt.values.shape)
    out = qt.values.to(dtype) * s
    return out.transpose(-2, -1) if qt.transposed else out


def quantize(x: torch.Tensor, spec: QuantSpec = QuantSpec(),
             validate: bool = False) -> QuantizedTensor:
    """Symmetric per-block int8 quantization over the last two dims; leading
    dims are independent matrices (layer or expert stacks).

    Degenerate inputs, as the reference's contract: an all-zero block gets
    scale 0 and exact-zero values; NaN/Inf propagate to the block's scale
    (its values are unspecified); validate=True raises on a non-finite input
    instead."""
    if x.ndim < 2:
        raise ValueError(f"quantize needs a matrix, got shape {tuple(x.shape)}")
    if validate and not bool(torch.isfinite(x).all()):
        raise ValueError("quantize(validate=True): input contains NaN/Inf — refusing "
                         "to pack a corrupt tensor (the scale would be non-finite)")
    if spec.transpose:
        x = x.transpose(-2, -1)
    m, n = x.shape[-2:]
    qm, qn = _fit_block(spec.block_m, m), _fit_block(spec.block_n, n)
    lead = tuple(x.shape[:-2])
    xb = x.float().reshape(lead + (m // qm, qm, n // qn, qn))
    amax = xb.abs().amax(dim=(-3, -1))                          # (..., sm, sn)
    # tensor / tensor: CUDA turns a division by a scalar into a multiply by
    # its reciprocal, which is not the IEEE quotient the reference computes
    scales = amax / torch.full_like(amax, INT8_MAX)
    inv = torch.where(scales > 0, torch.ones_like(scales) / torch.clamp_min(scales, 1e-30),
                      torch.zeros_like(scales))
    q = torch.round(xb * inv[..., :, None, :, None])
    values = torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8).reshape(lead + (m, n))
    # elementwise ops keep a transposed input's strides: store row-major
    return QuantizedTensor(values=values.contiguous(), scales=scales.contiguous(),
                           block=(qm, qn), transposed=spec.transpose)


def scales_finite(qt: QuantizedTensor) -> bool:
    """True iff every block scale is finite (no NaN/Inf was packed)."""
    return bool(torch.isfinite(qt.scales).all())


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


def matvec_error_bound(qt: QuantizedTensor, x: torch.Tensor) -> torch.Tensor:
    """Per-output bound of |W_q x - W x| over the STORED rows (the GEMV
    output axis) for the exact-dequant W8A16 kernels:
    err_i <= sum_b s[i_blk, b] / 2 * sum_{j in b} |x_j|."""
    if qt.values.ndim != 2:
        raise ValueError("matvec_error_bound covers 2-D quantized matrices")
    qm, qn = qt.block
    sn = qt.scales.shape[1]
    l1 = x.float().abs().reshape(sn, qn).sum(dim=1)              # (sn,)
    bound_blk = 0.5 * qt.scales * l1[None, :]                    # (sm, sn)
    return bound_blk.sum(dim=1).repeat_interleave(qm)            # (m,)


def packed_weight_bytes(shape: tuple, block: Tuple[int, int] = (64, None)) -> int:
    """Device bytes of an int8 block-scaled weight: 1 byte per element plus
    one f32 scale per block."""
    m, n = shape[-2:]
    lead = 1
    for d in shape[:-2]:
        lead *= d
    qm, qn = _fit_block(block[0], m), _fit_block(block[1], n)
    return lead * (m * n + (m // qm) * (n // qn) * 4)


def weight_traffic_ratio(shape: tuple, *, full_bytes_per_elem: int = 4,
                         block: Tuple[int, int] = (64, None)) -> float:
    """Full-precision weight bytes / packed bytes (~3.97x vs f32, ~1.98x vs
    bf16 at the default blocks)."""
    m, n = shape[-2:]
    lead = 1
    for d in shape[:-2]:
        lead *= d
    return lead * m * n * full_bytes_per_elem / packed_weight_bytes(shape, block)


# --------------------------------------------------------------------------
# KV-cache quantization (per-(token, head) block scales)
# --------------------------------------------------------------------------
#
# The decode step's other large byte term after the weights is the KV cache
# read inside attention.  A cache entry (..., T, H, hd) quantizes its last
# two dims with block (1, hd): one f32 scale per (token, head), so scales
# are (..., T, H, 1) and the attention kernel dequantizes each staged key or
# value row with one multiply.

#: the per-(token, head) KV spec: one scale per head vector
KV_SPEC = QuantSpec(block_m=1, block_n=None)


def quantize_kv(x: torch.Tensor) -> QuantizedTensor:
    """Per-(token, head) symmetric int8 quantization of a K or V block x
    (..., H, hd), typically (B, T, H, hd): values (..., H, hd) int8 and
    scales (..., H, 1) f32, block (1, hd), bitwise the reference's."""
    return quantize(x, KV_SPEC)


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """values (..., H, hd) int8 * scales (..., H, 1) in f32, cast once to
    `dtype`: the semantics every attention path is held to."""
    return (values.float() * scales.float()).to(dtype)
