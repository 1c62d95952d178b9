"""Dense GEMM with a fused epilogue: the Level-3 BLAS kernel.

Replaces `repro/kernels/gemm.py` (`_gemm_kernel`, Pallas call at :184) in
its dense "kn" form: C = epi(A @ B [, A @ B2]) with A (M, K), B and B2
(K, N), in f32, bf16 and f64.  Four CUDA kernels carry it, and `plan` picks
one from the shape, dtype and addresses alone:

- "wgmma": `csrc/gemm_sm90.cu`, the tensor cores fed by TMA, for every
  dense bf16 call and bf16 A against the packed "nk" and "kn" layouts TMA
  can address, over a (BM, BN) tile grid chosen to fill the card's SMs.
  TMA needs 16-byte row strides and base addresses: where K and N are
  multiples of 8 and the operands start on 16 bytes it reads them in place
  and K is split into deterministic slices where the grid is too small;
  otherwise (`Plan.stage`) each operand it cannot address is first copied
  into a buffer whose rows are padded to 16 bytes (`tma_rows`, one
  `Tensor.copy_` each) and K is not split;
- "dmma": `csrc/gemm_f64.cu`, the f64 tensor cores (mma.sync .f64) fed by
  a cp.async ring, for every f64 call with K > 0, the gate's two products
  included, over the tile grid chosen as for "wgmma" (no K split): dense,
  16-byte copies where they can address the rows (K % 2 == 0, N % 2 == 0,
  16-byte base addresses), 8-byte copies (one double) otherwise; packed
  (`csrc/gemm_f64_q8.cu`, every layout), A and the int8 rows copied 16
  bytes at a time (`Plan.stage`: first copied into rows padded to 16 bytes
  where they are not laid out so) and dequantized into the dense kernel's
  B tile (the dense launch's bits on the dequantized B);
- "ffma_sm90": FFMA on the CUDA cores (TF32 would change the result) fed
  by TMA through a shared-memory ring (`csrc/gemm_f32.cu`), for every dense
  f32 call with K > 0, the gate's two products included, over a (BM, BN)
  tile grid chosen as for "wgmma" (no K split): in place where K and N are
  multiples of 4 and the operands start on 16 bytes, otherwise
  (`Plan.stage`) on operands copied into rows padded to 4 floats
  (`tma_rows`), C then written one element at a time where N % 4 != 0
  or it starts off 16 bytes; and for a packed B under f32 A whose int8 rows
  TMA can address, the same ring with the int8 dequantized in its staging
  (`csrc/gemm_f32_q8.cu`): the BLAS f32 gemm, zamba2's LoRA merges and the
  f32 prefill projections of kernel 3's broadcast-B form, dense or packed;
- "ffma": `csrc/gemm.cu`, the first design: a shared-memory tiled GEMM on
  the CUDA cores whose threads each own 4 x 4 register blocks (the paper's
  DOT4 PE), now only for K = 0 (the epilogue alone) and the packed forms no
  other route takes: bf16 A against "kn" whose scale block ends inside a
  k-step or whose rows TMA cannot address, or "nk" with scales that vary
  along K, and f32 A whose int8 rows (or A's) TMA cannot address.  Its
  dense bodies and its f64 packed ones are reached only by chip_smoke.py's
  `ffma_launch` and `scripts/torch_gemm_study.py`, as the yardstick.

Each source note says what bounds its kernel.  Ragged edges are masked in
the kernels, where the reference pads in `ops._gemm_call`.

A packed B (`core.quant.QuantizedTensor`: int8 with f32 block scales, the
int8 body of `_gemm_kernel`, gemm.py:63-76) under bf16 A takes the wgmma
route in the output-major "nk" layout with one scale block across K
(`serve --quantize int8`'s), converted to bf16 in shared memory (exact) and
scaled in the accumulator, and in the "kn" layout (`quantize(w)`'s
default) where its scale block spans whole k-steps, converted by a
warpgroup of its own and each k-step's partial scaled as it is promoted.
Under f32 A every packed layout takes "ffma_sm90" where TMA can address
its int8 rows, each element dequantized once in f32 as the plain version
rounds it; under f64 A every layout takes "dmma".  The rest (bf16 "kn"
with a scale block inside a k-step or rows TMA cannot address, "nk" with
scales that vary along K, f32 whose rows TMA cannot address) runs
gemm.cu's int8-B variant (`gemm_q8_launch`), dequantized in the
accumulator type on the way into shared memory.  `launch_int8` binds them
(its own launch count; `kernels/bgemm.py` reaches them too) and
`reference_int8` is their plain version.

Kernel 3's batched-B form (`kernels/bgemm.py::launch_batched`: a B per
batch member, any output dtype) goes through `batched`, routed by
`plan_batched` to a batch coordinate (grid.z the member) on the kernel of
its 2-D counterpart: bf16 with bf16 or f32 out and N % 8 == 0 on "wgmma"
(`csrc/gemm_sm90.cu`'s batched instantiations: rank-3 TMA maps; A or B
staged where TMA cannot address them in place), the packed "kn" expert
stacks of `--quantize int8` with bf16 A there too (int8 converted in shared
memory, each k-step scaled as it is promoted), f64 with f64 out on "dmma"
(`csrc/gemm_f64.cu`; packed stacks `csrc/gemm_f64_q8.cu`), f32 with f32
out on "ffma_sm90" (rank-3 maps; dense
where TMA cannot address it in place, staged; packed stacks whose int8
rows TMA can address, dequantized in the ring's staging), and the rest on
"ffma" (`csrc/gemm_batched*.cu`: gemm.cu's tile with per-member strides and
the output type a template parameter).

`reference` and `reference_int8` are the plain PyTorch versions: CPU
tensors use them, and on the card only comparisons (`ops.reference_mode`)
do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.epilogue import make
from repro_torch.core.quant import dequantize_in, is_quantized
from repro_torch.kernels import _build

#: launches through `launch` in this process (either kernel)
launches = 0
#: launches of the int8-B variant through `launch_int8`
launches_int8 = 0
#: every launch of `launch` and `launch_int8`, by the route its plan named
launches_by_route = {"wgmma": 0, "dmma": 0, "ffma_sm90": 0, "ffma": 0}
#: the launches of `launch` that took a route's form for rows off 16 bytes:
#: "wgmma" and "ffma_sm90" with staged operands, "dmma" with 8-byte copies,
#: "ffma_sm90" with C one element a store (N % 4 != 0 or C off 16 bytes: the
#: ODD instantiations, csrc/gemm_f32_odd.cu)
launches_by_form = {"wgmma_staged": 0, "dmma_copy8": 0, "ffma_sm90_staged": 0,
                    "ffma_sm90_odd": 0}

#: the H100's streaming multiprocessors: the plan's default card
H100_SMS = 132
#: k per main-loop step of the tensor-core kernel (BK in csrc/gemm_sm90.cu)
BK = 64
#: (BM, BN) tiles of the tensor-core kernel, largest first.  Measured on the
#: H100 (PERF.md, PR 17): 128 x 128 runs 8192^3 fastest (2.08 ms; 128 x 64
#: 2.72, 64 x 64 3.77), the smaller tiles tie it at the prefill shapes, and
#: 256-wide tiles lost everywhere; the gate's two products take BN = 64.
TC_TILES = ((128, 128), (128, 64), (64, 64))
GATE_TILES = ((128, 64), (64, 64))
#: (BM, BN) tiles of the tensor-core kernel's batched form, with and without
#: the gate: the MoE experts' 32 or 64 rows a member take BM = 64; packed
#: "kn" B takes 64 x 64 only (the producer warpgroup's converter warps need
#: the registers a 128-row tile's second consumer warpgroup takes)
BATCHED_TILES = ((128, 64), (64, 64))
PACKED_BATCHED_TILES = ((64, 64),)
#: (BM, BN) tiles of the tensor-core kernel's 2-D int8 "kn" form, without
#: and with the gate: BM = 128 runs two consumer warpgroups beside two
#: converter warpgroups, one block an SM; BM = 64 the batched form's body.
#: Measured on the H100 (`scripts/torch_gemm_study.py packed`, PERF.md):
#: 8192^3 in 3.69 ms at 128 x 128, 4.86 at 64 x 64 and 5.94 at 128 x 64
#: (so no 128 x 64 without the gate); the gate at (4095, 4096) @ (4096,
#: 2064) in 0.504 ms at 128 x 64, 0.736 at 64 x 64
PACKED_TILES = ((128, 128), (64, 64))
PACKED_GATE_TILES = ((128, 64), (64, 64))
#: (BM, BN) tiles of the f64 tensor-core kernel (csrc/gemm_f64.cu), largest
#: first, and its gate's (two f64 accumulators: BN <= 64).  Measured on the
#: H100 (scripts/torch_gemm_study.py f64, PERF.md): 128 x 128 runs 8192^3
#: in 23.7-24.4 ms, 64 x 64 in 26.1-26.4; 128 x 64 was slower than 64 x 64
#: there and on a ragged 4095 x 4094, so it serves only the gate (46.8-48.5
#: ms against 49.7-55.8 at 64 x 64)
DMMA_TILES = ((128, 128), (64, 64))
DMMA_GATE_TILES = ((128, 64), (64, 64))
#: the packed f64 kernel's gate tiles (csrc/gemm_f64_q8.cu; without the gate
#: DMMA_TILES): 64 x 64 only, since at 128 x 64 ptxas spilled 12 bytes in
#: the "kn" form at every register split tried (PERF.md, PR 30)
DMMA_Q8_GATE_TILES = ((64, 64),)
#: (BM, BN) tiles of the f32 CUDA-core kernel on the TMA ring
#: (csrc/gemm_f32.cu), largest first, and its gate's (two accumulators: BN
#: <= 64).  Measured on the H100 (`scripts/torch_gemm_study.py f32`,
#: PERF.md): 128 x 128 runs 8192^3 and the LoRA merge fastest, 128 x 64 the
#: 512-row prefill shapes, 64 x 64 the smoke serves' few rows
FFMA_SM90_TILES = ((128, 128), (128, 64), (64, 64))
FFMA_SM90_GATE_TILES = ((128, 64), (64, 64))
#: ... and of its batched form, which adds 32 x 64 for the MoE experts' 32
#: rows a member (at 64 x 64 half of every tile's FFMAs run on zero rows)
FFMA_SM90_BATCHED_TILES = FFMA_SM90_TILES + ((32, 64),)
FFMA_SM90_BATCHED_GATE_TILES = FFMA_SM90_GATE_TILES + ((32, 64),)
#: the first CUDA-core kernel's fixed tile (csrc/gemm.cu), without and with
#: a gate
FFMA_TILE = {False: (128, 128), True: (128, 64)}
#: the largest tile whose grid fills this share of the SMs is taken (q/k/v's
#: 128 tiles of 128 x 64 on 132 SMs rather than 64 of 128 x 128) ...
FILL = 0.9
#: ... and K is split where even the smallest leaves more than this share
#: of them idle ...
IDLE = 0.5
#: ... and K is at least this long (a shorter K is a short loop already)
SPLIT_MIN_K = 1024

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def reference(a, b, *, b2=None, bias=None, residual=None, activation=None):
    """C = epi(a @ b [, a @ b2]) in max(f32, dtype), cast once to a's dtype."""
    epi = make(activation, bias=bias, gate=b2, residual=residual)
    acc = torch.promote_types(torch.float32, a.dtype)
    af = a.to(acc)
    h = af @ b.to(acc)
    h2 = af @ b2.to(acc) if b2 is not None else None
    return epi.apply(h, acc2=h2, bias=bias, residual=residual).to(a.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one GEMM runs: the route ("wgmma", "dmma", "ffma_sm90" or
    "ffma"), the (BM, BN) output tile, the number of K slices (wgmma only;
    the slices' partials are summed in slice order by a second pass) and,
    on "dmma", the bytes each cp.async of B's rows copies (dense 16 or 8,
    packed int8 16; 0 elsewhere); `stage`: an operand whose rows the
    kernel cannot address is first copied into a buffer whose rows are
    padded to 16 bytes (`tma_rows`), and K is not split ("wgmma" and
    "ffma_sm90": rows TMA cannot address; packed "dmma": A or int8 rows
    that are not a multiple of 16 bytes on 16 bytes)."""

    route: str
    tile: tuple
    splits: int = 1
    copy: int = 0
    stage: bool = False

    def k_slices(self, k: int) -> list:
        """[(k0, k1), ...]: each slice whole BK-steps of K, in the kernel's
        order (slice s covers steps s * steps // splits up to the next)."""
        steps = -(-k // BK)
        cuts = [s * steps // self.splits for s in range(self.splits + 1)]
        return [(a * BK, min(b * BK, k)) for a, b in zip(cuts, cuts[1:])]


@functools.lru_cache(maxsize=4096)  # a serve plans a few dozen shapes
def plan(m: int, k: int, n: int, dtype, gate: bool = False, packed_layout=None, block=None,
         aligned: bool = True, b_aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The route, tile and K split of C (m, n) = A (m, k) @ B, from the shape,
    the dtype and the addresses alone.

    packed_layout: None for a dense B; for a packed B "nk" when it is stored
    output-major with one scale block across all of K (the serving layout),
    "kn" when stored (K, N), "nk-kblocks" when output-major with scales that
    vary along K; block: its scale block (qa, qb) over the stored layout.
    aligned: every operand's base address is 16-byte aligned; b_aligned: a
    packed B's (and B2's) int8 values are.

    bf16 takes "wgmma" when B is dense, staged where TMA cannot address A or
    B (K % 8 != 0, N % 8 != 0 or unaligned), when B is "nk" and TMA can
    (K % 16 == 0, N % 8 == 0, aligned), and when B is "kn" with a scale
    block of whole k-steps (qa % BK == 0) and int8 rows TMA can address (N
    % 16 == 0, b_aligned), A staged where it is off 16 bytes (on the
    PACKED_TILES, never splitting K); f64 takes "dmma": dense with 16-byte
    copies when they can address A and B (K % 2 == 0 and N % 2 == 0, the
    gate too), else 8-byte ones; packed (every layout) with 16-byte
    copies on the dense plan's tile (the gate's: 64 x 64), staged where A's rows or the stored
    int8 rows are not a multiple of 16 bytes on 16 bytes (`_q8_in_place`);
    dense f32 takes "ffma_sm90", staged where TMA
    cannot address A or B in place (K % 4 != 0, N % 4 != 0 or unaligned);
    packed f32 takes "ffma_sm90" where TMA can address A and the stored int8
    rows (`_q8_tma`, aligned); everything else "ffma" (the other packed
    bf16 forms and f32 forms, and a K of 0: the epilogue alone).
    The tile is the largest of the route's tiles (TC_TILES or PACKED_TILES,
    DMMA_TILES, FFMA_SM90_TILES; with the gate GATE_TILES or
    PACKED_GATE_TILES, DMMA_GATE_TILES or, packed, DMMA_Q8_GATE_TILES,
    FFMA_SM90_GATE_TILES) whose grid
    fills FILL of the `sms` SMs, else the smallest; on "wgmma" unstaged and
    unpacked or "nk", where that grid leaves more than IDLE of them idle
    and K >= SPLIT_MIN_K, K is split so that tiles x splits is about half a
    wave (at least 2 slices, at most one per 2 k-steps: the second pass
    reads every slice's partials)."""
    nonempty = min(m, k, n) > 0
    some = aligned and nonempty
    dense = nonempty and packed_layout is None
    if dtype == torch.float64 and nonempty:
        if dense:
            tile = _fill(m, n, DMMA_GATE_TILES if gate else DMMA_TILES, sms)[0]
            return Plan("dmma", tile, copy=16 if some and k % 2 == 0 and n % 2 == 0 else 8)
        tile = _fill(m, n, DMMA_Q8_GATE_TILES if gate else DMMA_TILES, sms)[0]
        return Plan("dmma", tile, copy=16,
                    stage=not _q8_in_place(k, n, packed_layout, aligned, b_aligned))
    if dtype == torch.float32 and (dense or (some and _q8_tma(k, n, packed_layout))):
        return Plan("ffma_sm90", _fill(m, n, FFMA_SM90_GATE_TILES if gate else FFMA_SM90_TILES,
                                       sms)[0],
                    stage=dense and not (aligned and k % 4 == 0 and n % 4 == 0))
    if (dtype == torch.bfloat16 and nonempty and packed_layout == "kn"
            and _kn_tma(n, block, b_aligned)):
        tiles = PACKED_GATE_TILES if gate else PACKED_TILES
        return Plan("wgmma", _fill(m, n, tiles, sms)[0], stage=not aligned)
    tma = (dtype == torch.bfloat16 and some and n % 8 == 0
           and packed_layout in (None, "nk") and k % (16 if packed_layout else 8) == 0)
    if not tma and not (dtype == torch.bfloat16 and dense):
        return Plan("ffma", FFMA_TILE[bool(gate)])
    (bm, bn), tiles = _fill(m, n, GATE_TILES if gate else TC_TILES, sms)
    splits = 1
    if tma and tiles < (1 - IDLE) * sms and k >= SPLIT_MIN_K:
        splits = max(2, min(-(-sms // (2 * tiles)), -(-k // BK) // 2))
    return Plan("wgmma", (bm, bn), splits, stage=not tma)


def _q8_tma(k: int, n: int, layout: str) -> bool:
    """TMA can address f32 A (K % 4 == 0) and the stored int8 rows of a
    packed B (a multiple of 16 bytes: N for "kn", K for "nk")."""
    return k % 4 == 0 and (n if layout == "kn" else k) % 16 == 0


def _kn_tma(n: int, block, b_aligned: bool) -> bool:
    """The tensor-core kernel takes a packed "kn" B under bf16 A: its scale
    block spans whole k-steps (qa % BK == 0, so a k-step's partial takes one
    scale row) and TMA can address its int8 rows (N % 16 == 0, B and B2 on
    16 bytes)."""
    return block is not None and block[0] % BK == 0 and n % 16 == 0 and b_aligned


def _q8_in_place(k: int, n: int, layout: str, a_aligned: bool, b_aligned: bool) -> bool:
    """The packed f64 kernel's 16-byte copies can read f64 A (K even, on 16
    bytes) and the stored int8 rows of a packed B (N bytes for "kn", K for
    "nk": a multiple of 16, on 16 bytes) where they lie."""
    return a_aligned and b_aligned and k % 2 == 0 and (n if layout == "kn" else k) % 16 == 0


def _fill(m: int, n: int, tiles_largest_first, sms: int):
    """(the largest tile whose grid fills FILL of the SMs, else the smallest;
    that tile's grid size)."""
    for bm, bn in tiles_largest_first:
        tiles = -(-m // bm) * -(-n // bn)
        if tiles >= FILL * sms:
            break
    return (bm, bn), tiles


#: output dtypes the tensor-core kernel writes, each an instantiation of its
#: own (csrc/gemm_sm90.cu): bf16, and f32 for the MoE's down projection
TC_OUT_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=4096)
def plan_batched(batch: int, m: int, k: int, n: int, dtype, out_dtype=None, gate: bool = False,
                 packed_layout=None, block=None, a_aligned: bool = True,
                 b_aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The route and tile of the batched launch C[z] (m, n) = A[z] (m, k) @
    B[z] for z < batch (one B shared by every member, or one each), from the
    shapes, dtypes and addresses alone.  out_dtype None is A's dtype.
    packed_layout: None for a dense B, else `packed_layout`'s name of the
    packed B, whose scale block over its stored layout is `block` (qa, qb).
    a_aligned / b_aligned: A / B and B2 start on 16 bytes (C, which
    ops.bgemm allocates, always does).

    - bf16 A and dense B, out bf16 or f32, n % 8 == 0: "wgmma", with
      `stage` where TMA cannot address A or B in place (k % 8 != 0 or a
      base off 16 bytes: `tma_rows` copies that operand);
    - bf16 A and a packed "kn" B whose scale block spans whole k-steps (qa
      % BK == 0) and whose int8 rows TMA can address (n % 16 == 0, B on 16
      bytes), out bf16 or f32: "wgmma" (A staged where it is off 16 bytes);
    - f64 with f64 out: "dmma"; dense with 16-byte copies where K and N
      are even and every operand starts on 16 bytes (`copy` 16), else 8;
      packed (every layout) with 16-byte copies, staged as `plan` stages
      them;
    - f32 with f32 out: "ffma_sm90", a dense B with `stage` where TMA
      cannot address A or B in place (k % 4 != 0, n % 4 != 0 or a base off
      16 bytes), a packed one (any layout) where TMA can address A and its
      int8 rows (`_q8_tma`, A and B on 16 bytes);
    - everything else (another out dtype, bf16 with n % 8 != 0, packed
      bf16 "nk" or a scale block inside a k-step, packed f32
      whose rows TMA cannot address, K = 0): "ffma", csrc/gemm_batched*.cu's
      CUDA-core tile, FFMA_TILE.
    The tile is the largest of the route's tiles (BATCHED_TILES or
    PACKED_BATCHED_TILES, DMMA_TILES,
    FFMA_SM90_BATCHED_TILES; with the gate DMMA_GATE_TILES (packed
    DMMA_Q8_GATE_TILES),
    FFMA_SM90_BATCHED_GATE_TILES) whose batch x tiles grid fills FILL of the
    `sms` SMs and whose BM is under 2 m (at most half its rows past m),
    else the smallest; K is never split (the grid has batch x tiles
    blocks)."""
    out = out_dtype or dtype
    if min(batch, m, k, n) > 0:
        if dtype == out == torch.float64:
            tiles = DMMA_GATE_TILES if gate else DMMA_TILES
            if packed_layout is not None and gate:
                tiles = DMMA_Q8_GATE_TILES
            tile = _fill_batched(batch, m, n, tiles, sms)
            if packed_layout is None:
                wide = a_aligned and b_aligned and k % 2 == 0 and n % 2 == 0
                return Plan("dmma", tile, copy=16 if wide else 8)
            return Plan("dmma", tile, copy=16,
                        stage=not _q8_in_place(k, n, packed_layout, a_aligned, b_aligned))
        both = a_aligned and b_aligned
        if dtype == out == torch.float32 and (
                packed_layout is None or (both and _q8_tma(k, n, packed_layout))):
            tiles = FFMA_SM90_BATCHED_GATE_TILES if gate else FFMA_SM90_BATCHED_TILES
            return Plan("ffma_sm90", _fill_batched(batch, m, n, tiles, sms),
                        stage=packed_layout is None and not (both and k % 4 == 0
                                                             and n % 4 == 0))
        if dtype == torch.bfloat16 and out in TC_OUT_DTYPES:
            dense = packed_layout is None and n % 8 == 0
            kn = packed_layout == "kn" and _kn_tma(n, block, b_aligned)
            if dense or kn:
                stage = not (a_aligned and k % 8 == 0 and (kn or b_aligned))
                tiles = PACKED_BATCHED_TILES if kn else BATCHED_TILES
                return Plan("wgmma", _fill_batched(batch, m, n, tiles, sms), stage=stage)
    return Plan("ffma", FFMA_TILE[bool(gate)])


def _fill_batched(batch: int, m: int, n: int, tiles_largest_first, sms: int) -> tuple:
    """The largest tile whose batch x tiles grid fills FILL of the SMs and
    whose BM is under 2 m (the MoE experts' 32 or 64 rows a member take a
    tile of their height), else the smallest."""
    for bm, bn in tiles_largest_first:
        if bm < 2 * m and batch * -(-m // bm) * -(-n // bn) >= FILL * sms:
            return bm, bn
    return tiles_largest_first[-1]


def aligned(*tensors) -> bool:
    """Every given tensor starts on a 16-byte boundary (TMA's requirement)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def packed_layout(qb) -> str:
    """plan's `packed_layout` of a packed B (logical (K, N), or a stack of
    them)."""
    if not qb.transposed:
        return "kn"
    return "nk" if qb.block[1] == qb.values.shape[-1] else "nk-kblocks"


_TC_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 12 + [ctypes.c_void_p])


def tma_rows(x, zero_pad: bool = False):
    """(x, its row stride) for an x of rows r, columns c whose rows are 16
    bytes a multiple on a 16-byte base (c a multiple of 8 bf16, 4 f32, 2
    f64 or 16 int8); else (a copy of x into a buffer of rows padded to 16
    bytes, that stride).  TMA never reads the padding (it loads what lies
    past column c as zeros); `zero_pad` zeroes it for the packed f64
    kernel, whose 16-byte copies of A's last odd column read it."""
    c, per = x.shape[-1], 16 // x.element_size()
    if c % per == 0 and x.data_ptr() % 16 == 0:
        return x, c
    buf = torch.empty(x.numel() // c, -(-c // per) * per, dtype=x.dtype, device=x.device)
    buf[:, :c].copy_(x.reshape(-1, c))
    if zero_pad:
        buf[:, c:].zero_()
    return buf, buf.shape[1]


def tc(a, b, out, p: Plan, *, b2, bias, residual, act_code: int, m: int, k: int, n: int,
       scales=None, scales2=None, qa: int = 1, qb: int = 0, batch: int = 1):
    """Launch `gemm_tc_launch` (csrc/gemm_sm90.cu) on the current stream over
    m rows of a, with p's tile and K slices; b (b2) are bf16 (k, n), or int8
    stored (n, k) with f32 `scales` one per qa columns (qb == 0), or int8
    stored (k, n) with f32 scales one per (qa, qb) block (qb >= 1, "kn",
    unsplit).  With `p.stage`, a, b and b2 first go through `tma_rows`
    (which copies only an operand TMA cannot address).  The split-K
    workspace is allocated here.  batch > 1 or an f32 out (the batched-B
    form, unsplit, rank-3 maps): a holds `batch` matrices of m rows, out
    and residual `batch` of (m, n), b and b2 `batch` of (k, n) when 3-D
    (their scales `batch` of theirs), else one shared by every member."""
    lda, ldb = k, n
    per_member = int(b.ndim == 3)
    if p.stage:
        a, lda = tma_rows(a)
        b, ldb = tma_rows(b)
        if b2 is not None:
            b2, _ = tma_rows(b2)
    bm, bn = p.tile
    ws = None
    if p.splits > 1:
        ws = torch.empty((2 if b2 is not None else 1) * p.splits * m * n,
                         dtype=torch.float32, device=a.device)
    fn = _build.function("gemm_tc_launch", _TC_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), _build.ptr(b2), _build.ptr(scales),
                 _build.ptr(scales2), qa, qb, _build.ptr(bias), _build.ptr(residual),
                 out.data_ptr(), _build.ptr(ws), batch, per_member, m, k, n, lda, ldb,
                 act_code, int(out.dtype == torch.float32), bm, bn, p.splits, stream)
    if err:
        raise RuntimeError(f"gemm tensor-core kernel launch failed ({p}): CUDA error {err}")
    return out


_DMMA_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
#: gemm_f32_launch: (a, b, b2, bias, res, c, M, K, N, lda, ldb, act, bm, bn, stream)
_F32_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
#: the batched entries of both: (..., c, batch, b_batched, M, K, N[, lda, ldb], act, bm, bn[,
#: copy], stream)
_DMMA_BATCHED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_F32_BATCHED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
#: gemm_f32_q8_launch: (a, b, bs, b2, b2s, qa, qb, nk, bias, res, c, batch, b_batched, M, K,
#: N, act, bm, bn, stream)
_F32_Q8_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
#: gemm_f64_q8_launch: (a, b, bs, b2, b2s, qa, qb, nk, bias, res, c, batch, b_batched, M, K,
#: N, lda, ldq, act, bm, bn, stream)
_F64_Q8_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def _q8_operands(b, b2) -> tuple:
    """The packed int8-B kernels' leading arguments for a packed b (and b2):
    values, scales, b2's values and scales (or NULL), the scale block and
    whether b is stored output-major."""
    return (b.values.data_ptr(), b.scales.data_ptr(),
            None if b2 is None else b2.values.data_ptr(),
            None if b2 is None else b2.scales.data_ptr(), *b.block, int(b.transposed))


def dmma(a, b, out, p: Plan, *, b2, bias, residual, act_code: int, m: int, k: int, n: int,
         variant: int = 0, batch: int = 0):
    """Launch the f64 tensor-core kernel on the current stream over m rows of
    f64 a with p's tile and copy width: a packed b (and b2;
    `QuantizedTensor`, a stack of one a member when 3-D) `gemm_f64_q8_launch`
    (csrc/gemm_f64_q8.cu, batch 1 for the 2-D GEMM; with `p.stage` a, b's
    and b2's values first go through `tma_rows`, a's padding zeroed), a dense one
    `gemm_f64_launch` (csrc/gemm_f64.cu); `variant` 0 is the plan's kernel
    (1-4: the mma shapes m8n8k4, m16n8k4, m16n8k8, m16n8k16 and 5: BK = 32
    in 3 stages, at 128 x 128 with 16-byte copies and without the gate, for
    the sweep).  batch >= 1: `gemm_f64_batched_launch`, a, out and residual
    `batch` matrices, b and b2 `batch` of (k, n) when 3-D, else one shared
    by every member."""
    bm, bn = p.tile
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if is_quantized(b):
            v, v2 = b.values, None if b2 is None else b2.values
            lda, ldq = k, v.shape[-1]
            if p.stage:
                a, lda = tma_rows(a, zero_pad=True)
                v, ldq = tma_rows(v)
                v2 = None if v2 is None else tma_rows(v2)[0]
            fn = _build.function("gemm_f64_q8_launch", _F64_Q8_ARGTYPES)
            err = fn(a.data_ptr(), v.data_ptr(), b.scales.data_ptr(), _build.ptr(v2),
                     None if b2 is None else b2.scales.data_ptr(), *b.block, int(b.transposed),
                     _build.ptr(bias), _build.ptr(residual), out.data_ptr(), max(batch, 1),
                     int(b.values.ndim == 3), m, k, n, lda, ldq, act_code, bm, bn, stream)
            if err:
                raise RuntimeError(f"gemm f64 int8 tensor-core kernel launch failed ({p}): "
                                   f"CUDA error {err}")
            return out
        ptrs = (a.data_ptr(), b.data_ptr(), _build.ptr(b2), _build.ptr(bias),
                _build.ptr(residual), out.data_ptr())
        if batch:
            fn = _build.function("gemm_f64_batched_launch", _DMMA_BATCHED_ARGTYPES)
            err = fn(*ptrs, batch, int(b.ndim == 3), m, k, n, act_code, bm, bn, p.copy, stream)
        else:
            fn = _build.function("gemm_f64_launch", _DMMA_ARGTYPES)
            err = fn(*ptrs, m, k, n, act_code, bm, bn, variant, p.copy, stream)
    if err:
        raise RuntimeError(f"gemm f64 tensor-core kernel launch failed ({p}): CUDA error {err}")
    return out


def ffma_sm90(a, b, out, p: Plan, *, b2, bias, residual, act_code: int, m: int, k: int,
              n: int, batch: int = 0):
    """Launch the f32 ring on the current stream over m rows of f32 a with
    p's tile: a packed b (and b2; `QuantizedTensor`, a stack of one a member
    when 3-D) `gemm_f32_q8_launch` (csrc/gemm_f32_q8.cu), a dense one
    `gemm_f32_launch` (csrc/gemm_f32.cu; batch >= 1:
    `gemm_f32_batched_launch`, as `dmma`'s), with `p.stage` on a, b and b2
    through `tma_rows` (which copies only an operand TMA cannot address).
    batch >= 1: a, out and residual `batch` matrices, b and b2 `batch` of
    (k, n) when 3-D, else one shared by every member."""
    bm, bn = p.tile
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if is_quantized(b):
            fn = _build.function("gemm_f32_q8_launch", _F32_Q8_ARGTYPES)
            err = fn(a.data_ptr(), *_q8_operands(b, b2),
                     _build.ptr(bias), _build.ptr(residual), out.data_ptr(), max(batch, 1),
                     int(b.values.ndim == 3), m, k, n, act_code, bm, bn, stream)
            if err:
                raise RuntimeError(f"gemm f32 int8 ring kernel launch failed ({p}): CUDA error "
                                   f"{err}")
            return out
        lda, ldb, per_member = k, n, int(b.ndim == 3)
        if p.stage:  # (a 3-D operand comes back as rows: per_member is b's)
            a, lda = tma_rows(a)
            b, ldb = tma_rows(b)
            if b2 is not None:
                b2, _ = tma_rows(b2)
        ptrs = (a.data_ptr(), b.data_ptr(), _build.ptr(b2), _build.ptr(bias),
                _build.ptr(residual), out.data_ptr())
        if batch:
            fn = _build.function("gemm_f32_batched_launch", _F32_BATCHED_ARGTYPES)
            err = fn(*ptrs, batch, per_member, m, k, n, lda, ldb, act_code, bm, bn, stream)
        else:
            fn = _build.function("gemm_f32_launch", _F32_ARGTYPES)
            err = fn(*ptrs, m, k, n, lda, ldb, act_code, bm, bn, stream)
    if err:
        raise RuntimeError(f"gemm f32 TMA-ring kernel launch failed ({p}): CUDA error {err}")
    return out


def tally(p: Plan, by_route: dict, by_form: dict, out) -> None:
    """Count one launch of plan p into C `out` in a module's
    launches_by_route and launches_by_form."""
    by_route[p.route] += 1
    if p.stage:
        by_form[f"{p.route}_staged"] += 1
    if p.copy == 8:
        by_form["dmma_copy8"] += 1
    if p.route == "ffma_sm90" and (out.shape[-1] % 4 or out.data_ptr() % 16):
        by_form["ffma_sm90_odd"] += 1


def dense(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int, m: int) -> Plan:
    """C (m, n) = epi(A @ B [, A @ B2]) over m rows of a (the batch * M rows
    of bgemm's broadcast form) through the kernel `plan` names; returns the
    plan.  Operands are validated CUDA tensors (kernels/ops.py)."""
    k, n = b.shape
    p = plan(m, k, n, a.dtype, gate=b2 is not None, aligned=aligned(a, b, b2, out),
             sms=_build.sm_count(a.device.index or 0))
    if p.route == "wgmma":
        tc(a, b, out, p, b2=b2, bias=bias, residual=residual, act_code=act_code, m=m, k=k, n=n)
        return p
    if p.route in ("dmma", "ffma_sm90"):
        run = {"dmma": dmma, "ffma_sm90": ffma_sm90}[p.route]
        run(a, b, out, p, b2=b2, bias=bias, residual=residual, act_code=act_code, m=m, k=k,
            n=n)
        return p
    fn = _build.function("gemm_launch", _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(dtype_code, a.data_ptr(), b.data_ptr(), _build.ptr(b2), _build.ptr(bias),
                 _build.ptr(residual), out.data_ptr(), m, k, n, act_code, stream)
    if err:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {err}")
    return p


_BATCHED_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_long] * 2
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def batched(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int,
            out_code: int) -> Plan:
    """One batched launch: out[z] = epi(a[z] @ B[z] [, a[z] @ B2[z]]) for
    every z of a (batch, m, k), B (batch, k, n) or (k, n) shared, dense or
    packed (`QuantizedTensor`: values and scales with the same leading
    axis), out (batch, m, n) in any dtype, through the kernel
    `plan_batched` names; returns the plan.  Operands are validated CUDA
    tensors (kernels/ops.py); dtype_code / out_code are the C entry's dtype
    codes of a and out."""
    batch, m, k = a.shape
    n = b.shape[-1]
    packed = is_quantized(b)
    w, w2 = (b.values, None if b2 is None else b2.values) if packed else (b, b2)
    layout, block = (packed_layout(b), b.block) if packed else (None, None)
    p = plan_batched(batch, m, k, n, a.dtype, out.dtype, gate=b2 is not None,
                     packed_layout=layout, block=block, a_aligned=aligned(a),
                     b_aligned=aligned(w, w2), sms=_build.sm_count(a.device.index or 0))
    epi = dict(b2=w2, bias=bias, residual=residual, act_code=act_code, m=m, k=k, n=n)
    if p.route == "wgmma":
        if packed:
            tc(a, w, out, p, **epi, scales=b.scales, scales2=None if b2 is None else b2.scales,
               qa=block[0], qb=block[1], batch=batch)
        else:
            tc(a, w, out, p, **epi, batch=batch)
        return p
    if p.route in ("dmma", "ffma_sm90"):  # b and b2 as given: dense, or packed
        run = {"dmma": dmma, "ffma_sm90": ffma_sm90}[p.route]
        run(a, b, out, p, **dict(epi, b2=b2), batch=batch)
        return p
    batched_ffma(a, b, out, b2=b2, bias=bias, residual=residual, act_code=act_code,
                 dtype_code=dtype_code, out_code=out_code)
    return p


def batched_ffma(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int,
                 out_code: int):
    """`batched`'s launch on the CUDA-core tile (`gemm_batched_launch`,
    csrc/gemm_batched*.cu), which takes every batched form: the "ffma"
    route, and chip_smoke.py's first-tile times of the others."""
    batch, m, k = a.shape
    n = b.shape[-1]
    packed = is_quantized(b)
    w, w2 = (b.values, None if b2 is None else b2.values) if packed else (b, b2)
    sb = 0 if w.ndim == 2 else w.shape[-2] * w.shape[-1]
    qa = qbk = 1
    ss, scales, scales2 = 0, None, None
    if packed:
        (qa, qbk), scales = b.block, b.scales
        scales2 = None if b2 is None else b2.scales
        ss = 0 if w.ndim == 2 else scales.shape[-2] * scales.shape[-1]
    fn = _build.function("gemm_batched_launch", _BATCHED_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(dtype_code, out_code, a.data_ptr(), w.data_ptr(), _build.ptr(w2),
                 _build.ptr(scales), _build.ptr(scales2), qa, qbk, int(packed and b.transposed),
                 _build.ptr(bias), _build.ptr(residual), out.data_ptr(), batch, sb, ss, m, k, n,
                 act_code, stream)
    if err:
        raise RuntimeError(f"batched gemm CUDA-core kernel launch failed: CUDA error {err}")
    return out


def launch(a, b, out, *, b2, bias, residual, act_code: int, dtype_code: int):
    """One launch of the kernel `plan` names, counted; operands are
    validated CUDA tensors (kernels/ops.py), `out` is (M, N) and
    preallocated."""
    global launches
    p = dense(a, b, out, b2=b2, bias=bias, residual=residual, act_code=act_code,
              dtype_code=dtype_code, m=a.shape[0])
    launches += 1
    tally(p, launches_by_route, launches_by_form, out)
    return out


_Q_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
               + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def reference_int8(a, qb, *, qb2=None, bias=None, residual=None, activation=None):
    """The int8-B kernel's plain version: B (and B2) dequantized in max(f32,
    a's dtype) in logical (K, N) orientation, then the dense plain version."""
    acc = torch.promote_types(torch.float32, a.dtype)
    b2 = None if qb2 is None else dequantize_in(qb2, acc)
    return reference(a, dequantize_in(qb, acc), b2=b2, bias=bias, residual=residual,
                     activation=activation)


def q8(a, qb, out, *, qb2, bias, residual, m: int, act_code: int, dtype_code: int) -> str:
    """One int8-B launch over m rows of a (the batch * M rows of bgemm's
    broadcast form) through the kernel `plan` names: the tensor-core kernel
    for bf16 activations and "nk" weights with one scale block across K or
    "kn" weights with a scale block of whole k-steps, the f32 ring for f32
    activations whose int8 rows TMA can address, the f64 tensor cores for
    f64 activations, else `gemm_q8_launch`.  Returns the route; operands
    are validated CUDA tensors (kernels/ops.py)."""
    k, n = qb.shape
    qa, qbk = qb.block
    b2v = None if qb2 is None else qb2.values
    p = plan(m, k, n, a.dtype, gate=qb2 is not None, packed_layout=packed_layout(qb),
             block=qb.block, aligned=aligned(a, qb.values, b2v, out),
             b_aligned=aligned(qb.values, b2v), sms=_build.sm_count(a.device.index or 0))
    if p.route == "wgmma":
        tc(a, qb.values, out, p, b2=b2v, bias=bias, residual=residual, act_code=act_code,
           m=m, k=k, n=n, scales=qb.scales, scales2=None if qb2 is None else qb2.scales, qa=qa,
           qb=0 if qb.transposed else qbk)
        return p.route
    if p.route in ("dmma", "ffma_sm90"):
        run = {"dmma": dmma, "ffma_sm90": ffma_sm90}[p.route]
        run(a, qb, out, p, b2=qb2, bias=bias, residual=residual, act_code=act_code, m=m, k=k,
            n=n)
        return p.route
    fn = _build.function("gemm_q8_launch", _Q_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(dtype_code, a.data_ptr(), qb.values.data_ptr(), qb.scales.data_ptr(),
                 _build.ptr(b2v), None if qb2 is None else qb2.scales.data_ptr(), qa, qbk,
                 int(qb.transposed), _build.ptr(bias), _build.ptr(residual), out.data_ptr(),
                 m, k, n, act_code, stream)
    if err:
        raise RuntimeError(f"gemm int8 kernel launch failed: CUDA error {err}")
    return p.route


def launch_int8(a, qb, out, *, qb2, bias, residual, act_code: int, dtype_code: int):
    """C (M, N) = epi(A @ deq(B) [, A @ deq(B2)]): one int8-B launch, counted."""
    global launches_int8
    route = q8(a, qb, out, qb2=qb2, bias=bias, residual=residual, m=a.shape[0],
               act_code=act_code, dtype_code=dtype_code)
    launches_int8 += 1
    launches_by_route[route] += 1
    return out
