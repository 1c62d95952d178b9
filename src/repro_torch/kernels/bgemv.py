"""Batched GEMV with a fused epilogue: the decode-step projection kernel and
the BLAS library's batched GEMV.

Replaces `repro/kernels/bgemv.py` (`_bgemv_kernel`, Pallas call at :230) in
its whole dense contract: y[b] = epi(op(A[b]) x[b] [, op(A2[b]) x[b]])
with op = A^T (`transpose_a`, A ((batch,) k, n) streamed in its stored
layout: the decode projection x @ W) or op = A (A ((batch,) n, k)), a 2-D A
broadcast across the batch (bgemv.py:144, the index maps :195-208), in f32,
bf16 and f64, summed in max(f32, dtype).  Three CUDA kernels carry it, one
launch a call, each with a source note that says what bounds it on the card
(A over HBM) and what the design does about it:

- op = A^T, `csrc/bgemv.cu`: a broadcast A in column tiles of 128 bytes of
  every row, each A element read once for up to BATCH_CHUNK batch rows, K
  split across blocks whose partials the last block of each column tile
  sums in split order before the epilogue; a long member (per-member A) in
  column tiles of 512 bytes, one row a warp a step, split the same way;
- op = A, `csrc/bgemv_rows.cu`: gemv.cu's row-dot body, `wpr` warps a row,
  each A row read once for up to BATCH_CHUNK batch rows of x (broadcast A)
  or one long member's x (per-member A);
- a short member (per-member A of at most MEMBER_MAX_BYTES), both ops,
  `csrc/bgemv_members.cu`: a warp owns whole members and walks each as one
  flat stream of 16-byte loads, its lanes meeting by shuffle trees; a
  member's sums run in an order set by its shape alone, so its bits do not
  depend on the batch.

`plan` picks the form from the op and A's rank, the body from a member's
bytes, and the split from the shapes alone (op = A^T: the K split; op = A:
the warps a row).

The packed form (`_bgemv_kernel`'s int8 body, bgemv.py:80-83) is
`csrc/qgemv.cu`, one launch a call: W is a `core.quant.QuantizedTensor`
stored output-major (N, K), so each output is one dot over a stored row,
dequantized in the accumulator type; a block owns 32 weight rows and stages
its slice of x once in shared memory, and `plan_int8` picks the K split
(combined in the same launch, as the dense kernel's).  `launch_int8` binds
it (with its own launch count) and `reference_int8` is its plain version;
`kernels/gemv.py` reaches the same kernel at batch 1 through `qgemv`.

`reference` and `reference_int8` are the plain PyTorch versions: CPU
tensors use them, and on the card only comparisons (`ops.reference_mode`)
do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.epilogue import Epilogue
from repro_torch.core.quant import dequantize_in
from repro_torch.kernels import _build

#: launches of the dense kernels in this process (comparisons excluded: they
#: run the plain version)
launches = 0
#: the dense launches by form: the op (A^T "t": csrc/bgemv.cu; A "n":
#: csrc/bgemv_rows.cu) over a broadcast A or one A a member
FORMS = ("broadcast_t", "broadcast_n", "batched_t", "batched_n")
launches_by_form = dict.fromkeys(FORMS, 0)
#: the dense launches of the short-member body (csrc/bgemv_members.cu), a
#: part of launches_by_form's batched_t and batched_n
launches_members = 0
#: launches of the packed kernel (csrc/qgemv.cu) through `launch_int8`
launches_int8 = 0

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ROWS_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_MEMBERS_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
#: the H100's streaming multiprocessors: the plan's default card
H100_SMS = 132
#: batch members a block (BMAX in csrc/bgemv.cu)
BATCH_CHUNK = 4
#: rows a block takes a step (4 a warp, 8 warps) and at most (x's slice in
#: shared memory): ROW_STEP and MAX_ROWS in csrc/bgemv.cu
ROW_STEP, MAX_ROWS = 32, 1024
#: rows a split at least, where K allows two, without and with the gate:
#: the two batches of loads a lane keeps in flight (2 x UNROLL steps of 32
#: rows; UNROLL in csrc/bgemv.cu is 4, 2 under the gate's second weight)
MIN_ROWS = {False: 256, True: 128}
#: blocks per SM the K split stays within.  Measured on the H100
#: (scripts/torch_gemm_study.py bgemv, PERF.md), the fastest split at every
#: served decode shape fills about 2 blocks an SM: qkv 2048 -> 2048 8 x 256
#: rows (256 blocks) 11.7 us against 13.0 at 4 x 512 and 14.7 at 16 x 128;
#: rwkv 2048 -> 7168 2 x 1024 (224 blocks) 20.6 us against 23.1 at 4 x 512;
#: 2048 -> 64 8 x 256 (8 blocks) 8.4 us against 9.9 at 64 x 32
BLOCKS_PER_SM = 2
#: rows a per-member block of csrc/bgemv.cu takes a step (MEMBER_STEP
#: there: a row a warp); a K slice has no upper limit, x not being staged
MEMBER_ROW_STEP = 8

#: bytes of one member's A at most that take the short-member body
#: (csrc/bgemv_members.cu).  Measured on the H100 (scripts/torch_gemm_study.py
#: bgemv_members, PERF.md; us, the short body against `split_plan`'s long
#: bodies, about 32 MB of A a launch): it wins in every dtype and op up to
#: 18 KB a member ((48, 48) f64 op = A^T 17.6 against 19.3, op = A 18.7
#: against 21.4; (96, 96) bf16 19.6 and 19.8 against 21.6 and 25.6; (32, 32)
#: f64 17.1 and 18.6 against 28.2 and 23.7) but for a tie at (64, 64) f32
#: op = A^T (17.7 against 17.3), and loses op = A^T at 32 KB ((64, 64) f64
#: 17.9 against 16.8, (128, 128) bf16 21.1 against 19.3)
MEMBER_MAX_BYTES = 20 * 1024
#: members a block of the short-member body (8 warps, one member a warp):
#: 8 was as fast as 16 or faster at 24 of the 30 measured (shape, dtype, op)
#: cells and within 1.4 us at the others, 32 and 64 slower still (a warp's
#: members run one after another)
MEMBERS = 8


#: warps a block of csrc/bgemv_rows.cu (the op = A body), shared by its rows
ROW_WARPS = 8
#: 16-byte loads a lane issues together in a row sweep (gemv.cu, bgemv_rows.cu)
ROW_UNROLL = 4
#: rows of A a warp of csrc/bgemv_rows.cu takes (ROW_BLOCK there) where one
#: warp takes a row and either x has several rows (a broadcast A) or a row is
#: shorter than one sweep of the warp's 16-byte loads.  Measured on the H100
#: (scripts/torch_gemm_study.py bgemv_rows, PERF.md): broadcast (8192, 8192)
#: x 4 rows bf16 53.7 us against 63.0 at one row a warp; 4096 members of
#: (32, 32) f64 24.0 against 37.0; one (2048, 2048) A a member 1-4% slower.
#: Half as many under the gate, whose second sums take the other rows'
#: registers (f64 spilled at 4 rows and the gate)
ROW_BLOCK = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one bgemv runs.  A short member (`members` > 0, per-member A,
    csrc/bgemv_members.cu, either op): `members` members a block, one warp
    a member; tile, rows and wpr are 0, splits 1.  Otherwise op = A^T
    (`trans`, csrc/bgemv.cu): `tile` columns a block (128 bytes of a row;
    512 when `batched`), K cut into `splits` slices of `rows` rows (a
    multiple of ROW_STEP; of MEMBER_ROW_STEP when `batched`; the last may
    be short), each slice one block per column tile and batch chunk (one
    member a chunk when `batched`).  op = A (csrc/bgemv_rows.cu): `wpr`
    warps a row (the K split, summed in warp order) and `rows` rows a warp
    (1, or ROW_BLOCK (ROW_BLOCK / 2 under the gate) with wpr 1), ROW_WARPS
    // wpr * rows rows a block, one block per row group and batch chunk;
    tile and splits are 0 and 1."""

    tile: int
    splits: int
    rows: int
    batched: bool = False
    trans: bool = True
    wpr: int = 0
    members: int = 0

    @property
    def form(self) -> str:
        """The launch_counts() form: "broadcast_t", "batched_n", ..."""
        return ("batched_" if self.batched else "broadcast_") + ("t" if self.trans else "n")

    def k_slices(self, k: int) -> list:
        """[(k0, k1), ...]: the rows of each split, in the order the last
        block of a column tile sums their partials (a short member: all of
        K at once)."""
        if self.members:
            return [(0, k)]
        return [(s * self.rows, min(k, (s + 1) * self.rows)) for s in range(self.splits)]

    def chunks(self, b: int) -> int:
        """Batch chunks of the launch: a member each, or BATCH_CHUNK rows."""
        return b if self.batched else _cdiv(b, BATCH_CHUNK)

    def blocks(self, b: int, n: int) -> int:
        """Blocks of the launch over b batch rows and n outputs."""
        if self.members:
            return _cdiv(b, self.members)
        if not self.trans:
            return _cdiv(n, ROW_WARPS // self.wpr * self.rows) * self.chunks(b)
        return _cdiv(n, self.tile) * self.splits * self.chunks(b)


def warps_per_row(m: int, n: int, elem_size: int, sms: int) -> int:
    """Warps sharing a row of n elements among m rows (gemv.cu and
    bgemv_rows.cu): 1 while the rows give ~32 warps per SM, doubling (up to
    8) for fewer rows as long as each warp keeps at least two unrolled
    sweeps of 16-byte loads."""
    sweep = 32 * (16 // elem_size) * ROW_UNROLL  # elements of one unrolled warp sweep
    wpr = 1
    while wpr < 8 and m * wpr < 32 * sms and n // (2 * wpr) >= 2 * sweep:
        wpr *= 2
    return wpr


@functools.lru_cache(maxsize=1024)  # a serve plans a few dozen shapes
def plan(b: int, k: int, n: int, dtype, gate: bool = False, sms: int = H100_SMS, *,
         trans: bool = True, batched: bool = False) -> Plan:
    """The form, body and split of y (b, n) = op(A) x over a contraction of
    k (op = A^T: A (k, n), or (b, k, n) when `batched`; op = A: A (n, k) or
    (b, n, k)) [with A2], from the shapes and the dtype alone.

    A member (`batched`) of at most MEMBER_MAX_BYTES of A takes the
    short-member body, MEMBERS members a block: the plan is the same at
    every b, and so are the member's bits.  Anything else: `split_plan`."""
    if batched and k * n * (torch.finfo(dtype).bits // 8) <= MEMBER_MAX_BYTES:
        return Plan(0, 1, 0, True, trans, members=MEMBERS)
    return split_plan(b, k, n, dtype, gate, sms, trans=trans, batched=batched)


def split_plan(b: int, k: int, n: int, dtype, gate: bool = False, sms: int = H100_SMS, *,
               trans: bool = True, batched: bool = False) -> Plan:
    """The split of csrc/bgemv.cu (op = A^T) or csrc/bgemv_rows.cu (op = A),
    the bodies of a broadcast A and of a long member (`plan`'s arguments).

    op = A^T: the column tile and K split; as many splits as keep column
    tiles x batch chunks x splits within BLOCKS_PER_SM blocks an SM, with at
    least MIN_ROWS[gate] rows each (and at most MAX_ROWS under a broadcast
    A); the rows of a split are K / splits rounded up to whole row steps.
    op = A: the warps a row, `warps_per_row` over the n rows of every batch
    chunk, and ROW_BLOCK rows a warp (half as many under the gate) where
    that is one and A is broadcast or its rows are shorter than a warp's
    sweep of 16-byte loads."""
    elem = torch.finfo(dtype).bits // 8
    chunks = b if batched else _cdiv(b, BATCH_CHUNK)
    if not trans:
        wpr = warps_per_row(n * chunks, k, elem, sms)
        block = wpr == 1 and (not batched or k * elem < 32 * 16)
        rows = ROW_BLOCK // (2 if gate else 1) if block else 1
        return Plan(0, 1, rows, batched, False, wpr)
    tile, step = (512 // elem, MEMBER_ROW_STEP) if batched else (128 // elem, ROW_STEP)
    base = _cdiv(n, tile) * chunks
    splits = max(1, min(BLOCKS_PER_SM * sms // max(base, 1), k // MIN_ROWS[bool(gate)]))
    rows = max(step, _cdiv(_cdiv(k, splits), step) * step)
    if not batched:
        rows = min(MAX_ROWS, rows)
    return Plan(tile, max(1, _cdiv(k, rows)), rows, batched)


#: weight rows a block of csrc/qgemv.cu owns: on the tensor cores ("tc":
#: bf16 x, one scale a row) 16 rows, each with its gate row, whose K slice
#: the block's 8 warps share; on the CUDA cores ("ffma": f32 / f64 x, other
#: scale blocks) 8 warps x 4 stored rows, or x 2 rows and their gate rows
INT8_ROWS = {("tc", False): 16, ("tc", True): 16, ("ffma", False): 32, ("ffma", True): 16}
#: columns a split at least: every warp of the block at least one 128-column
#: step ("tc"), or two 512-column steps, the loads a lane keeps in flight
#: ("ffma")
INT8_MIN_COLS = 1024
#: bytes of x's slice the CUDA-core body stages in shared memory at most,
#: in the accumulator type (MAX_X_BYTES in csrc/qgemv.cu); the tensor-core
#: body reads x through L1
INT8_MAX_X_BYTES = 64 * 1024
#: blocks per SM the K split stays within, by route (blocks of 256 threads)
INT8_BLOCKS_PER_SM = {"tc": 1, "ffma": 2}


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """How one packed GEMV runs: the body (`route`, "tc" or "ffma"), `rows`
    stored rows a block, K cut into `splits` slices of `cols` columns (a
    multiple of 16 when split; the last may be short), each slice one block
    per row group and batch chunk; `warps` a block (on the tensor cores, the
    warps sharing the block's slice: 8, or 4 where the row groups alone fill
    the card)."""

    route: str
    rows: int
    splits: int
    cols: int
    warps: int = 8

    def k_slices(self, k: int) -> list:
        """[(k0, k1), ...]: the columns of each split, in the order the last
        block of a row group sums their partials."""
        return [(s * self.cols, min(k, (s + 1) * self.cols)) for s in range(self.splits)]

    def blocks(self, b: int, n: int) -> int:
        """Blocks of the launch over b batch rows and n outputs."""
        return _cdiv(n, self.rows) * self.splits * _cdiv(b, BATCH_CHUNK)

    def x_bytes(self, b: int, dtype) -> int:
        """Shared memory a block stages x's slice in (accumulator type; none
        on the tensor cores, which read x through L1)."""
        if self.route == "tc":
            return 0
        return min(b, BATCH_CHUNK) * self.cols * _acc_bytes(dtype)


def _acc_bytes(dtype) -> int:
    return 8 if dtype == torch.float64 else 4


def int8_route(k: int, dtype, row_scale: bool, aligned: bool = True) -> str:
    """"tc" for bf16 x under one scale a row (the serving spec) with K a
    multiple of 16 and the packed rows on 16-byte boundaries; "ffma"
    otherwise."""
    tc = dtype == torch.bfloat16 and row_scale and k % 16 == 0 and aligned
    return "tc" if tc else "ffma"


@functools.lru_cache(maxsize=1024)
def plan_int8(b: int, k: int, n: int, dtype, gate: bool = False, row_scale: bool = True,
              aligned: bool = True, sms: int = H100_SMS) -> Int8Plan:
    """The body and K split of the packed y (b, n) = deq(W) (n, k) x (b, k)
    [with W2] for x of `dtype` (`row_scale`: one scale block across K;
    `aligned`: the packed values start on 16 bytes), from the shapes alone: 4 warps a tensor-core block where the row groups
    alone outnumber the SMs, else 8; as many splits as keep row groups x
    batch chunks x splits within INT8_BLOCKS_PER_SM blocks an SM, with at least
    INT8_MIN_COLS columns each, and at least as many as put x's slice within
    INT8_MAX_X_BYTES; a split's columns are K / splits rounded up to 16."""
    route = int8_route(k, dtype, row_scale, aligned)
    rows = INT8_ROWS[(route, bool(gate))]
    base = _cdiv(n, rows) * _cdiv(b, BATCH_CHUNK)
    warps = 4 if route == "tc" and base > sms else 8
    splits = max(1, min(INT8_BLOCKS_PER_SM[route] * sms // max(base, 1), k // INT8_MIN_COLS))
    while True:
        cols = k if splits == 1 else _cdiv(_cdiv(k, splits), 16) * 16
        p = Int8Plan(route, rows, _cdiv(k, cols), cols, warps)
        if p.x_bytes(b, dtype) <= INT8_MAX_X_BYTES:
            return p
        splits += 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reference(w, x, *, w2=None, bias=None, residual=None, activation=None,
              transpose_a: bool = True):
    """y[b] = epi(op(w[b]) x[b] [, op(w2[b]) x[b]]) in max(f32, dtype), cast
    once to x's dtype: op = A^T (`transpose_a`, w ((batch,) k, n): x @ w)
    or op = A (w ((batch,) n, k)); a 2-D w is broadcast across the batch."""
    epi = Epilogue(activation, bias is not None, w2 is not None, residual is not None)
    acc_dt = torch.promote_types(torch.float32, x.dtype)
    xf = x.to(acc_dt)

    def product(a):
        a = a.to(acc_dt)
        if not transpose_a:
            a = a.transpose(-2, -1)
        return xf @ a if a.ndim == 2 else (xf[:, None, :] @ a)[:, 0, :]

    acc2 = product(w2) if w2 is not None else None
    return epi.apply(product(w), acc2=acc2, bias=bias, residual=residual).to(x.dtype)


def _deq_kn(qt, acc_dt):
    """A packed weight dequantized in `acc_dt` as the (K, N) operand of
    y = x @ W: the logical (d, f) for output-major storage, else the
    transpose of the stored (N, K) rows."""
    w = dequantize_in(qt, acc_dt)
    return w if qt.transposed else w.t()


def reference_int8(qw, x, *, qw2=None, bias=None, residual=None, activation=None):
    """The packed kernel's plain version: y[b, i] = epi(sum_k deq(W)[i, k]
    x[b, k] [, ...W2]) over W's stored rows, dequantized in the accumulator
    dtype max(f32, x's dtype), then the dense plain version."""
    acc_dt = torch.promote_types(torch.float32, x.dtype)
    w2 = None if qw2 is None else _deq_kn(qw2, acc_dt)
    return reference(_deq_kn(qw, acc_dt), x, w2=w2, bias=bias, residual=residual,
                     activation=activation)


def run(w, x, out, p: Plan, *, w2, bias, residual, act_code: int, dtype_code: int):
    """Launch plan p's kernel on the current stream, uncounted: a short
    member's `bgemv_members_launch` (csrc/bgemv_members.cu), op = A^T
    `bgemv_launch` (csrc/bgemv.cu; the workspace is allocated here) or op =
    A `bgemv_rows_launch` (csrc/bgemv_rows.cu).  Operands are validated CUDA
    tensors (kernels/ops.py), w ((batch,) k, n) under op = A^T and
    ((batch,) n, k) under op = A, `out` is (B, N) and preallocated."""
    b = x.shape[0]
    batched = int(w.ndim == 3)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if p.members:  # R stored rows of N elements a member, either op
            r, n = w.shape[-2:]
            fn = _build.function("bgemv_members_launch", _MEMBERS_ARGTYPES)
            err = fn(dtype_code, w.data_ptr(), _build.ptr(w2), x.data_ptr(), _build.ptr(bias),
                     _build.ptr(residual), out.data_ptr(), b, r, n, batched, int(p.trans),
                     p.members, act_code, stream)
        elif not p.trans:
            n, k = w.shape[-2:]
            fn = _build.function("bgemv_rows_launch", _ROWS_ARGTYPES)
            err = fn(dtype_code, w.data_ptr(), _build.ptr(w2), x.data_ptr(), _build.ptr(bias),
                     _build.ptr(residual), out.data_ptr(), b, n, k, batched, p.wpr, p.rows,
                     act_code, stream)
        else:
            k, n = w.shape[-2:]
            ws = tickets = None
            if p.splits > 1:  # partials of every K split, summed in order by the last block
                ws = torch.empty((2 if w2 is not None else 1) * p.splits * b * n,
                                 dtype=torch.promote_types(torch.float32, x.dtype),
                                 device=x.device)
                tickets = _build.tickets(x.device, _cdiv(n, p.tile) * p.chunks(b))
            fn = _build.function("bgemv_launch", _ARGTYPES)
            err = fn(dtype_code, w.data_ptr(), _build.ptr(w2), x.data_ptr(), _build.ptr(bias),
                     _build.ptr(residual), out.data_ptr(), _build.ptr(ws), _build.ptr(tickets),
                     b, k, n, p.splits, p.rows, act_code, batched, stream)
    if err:
        raise RuntimeError(f"bgemv kernel launch failed ({p}): CUDA error {err}")
    return out


def plan_for(w, x, gate: bool = False, transpose_a: bool = True, sms: int = H100_SMS) -> Plan:
    """`plan` of a call's operands, from their shapes and x's dtype alone."""
    if transpose_a:
        k, n = w.shape[-2:]
    else:
        n, k = w.shape[-2:]
    return plan(x.shape[0], k, n, x.dtype, gate=gate, sms=sms, trans=transpose_a,
                batched=w.ndim == 3)


def launch(w, x, out, *, w2, bias, residual, act_code: int, dtype_code: int,
           transpose_a: bool = True):
    """One launch of the kernel over the plan of the shapes, counted (by
    form, and the short-member body apart)."""
    global launches, launches_members
    p = plan_for(w, x, w2 is not None, transpose_a, _build.sm_count(x.device.index or 0))
    run(w, x, out, p, w2=w2, bias=bias, residual=residual, act_code=act_code,
        dtype_code=dtype_code)
    launches += 1
    launches_by_form[p.form] += 1
    launches_members += bool(p.members)
    return out


_Q_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def run_int8(qw, x, out, p: Int8Plan, *, qw2, bias, residual, act_code: int, dtype_code: int):
    """Launch `qgemv_launch` (csrc/qgemv.cu) on the current stream with plan
    p, uncounted: out (B, N) = epi over the stored (N, K) int8 rows of qw
    (and qw2); operands are validated CUDA tensors (kernels/ops.py), the
    workspace is allocated here."""
    n, k = qw.values.shape
    b = x.shape[0]
    qm, qn = qw.block
    ws = tickets = None
    if p.splits > 1:  # partials of every K split, summed in order by the last block
        ws = torch.empty((2 if qw2 is not None else 1) * p.splits * b * n,
                         dtype=torch.promote_types(torch.float32, x.dtype), device=x.device)
        tickets = _build.tickets(x.device, _cdiv(n, p.rows) * _cdiv(b, BATCH_CHUNK))
    fn = _build.function("qgemv_launch", _Q_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(dtype_code, qw.values.data_ptr(), qw.scales.data_ptr(),
                 None if qw2 is None else qw2.values.data_ptr(),
                 None if qw2 is None else qw2.scales.data_ptr(), x.data_ptr(),
                 _build.ptr(bias), _build.ptr(residual), out.data_ptr(), _build.ptr(ws),
                 _build.ptr(tickets), b, k, n, qm, qn, p.splits, p.cols, act_code,
                 p.warps if p.route == "tc" else 0, stream)
    if err:
        raise RuntimeError(f"qgemv kernel launch failed ({p}): CUDA error {err}")
    return out


def qgemv(qw, x, out, *, qw2, bias, residual, act_code: int, dtype_code: int):
    """One `qgemv_launch` over the plan of the shapes, uncounted."""
    n, k = qw.values.shape
    aligned = all(q.values.data_ptr() % 16 == 0 for q in (qw, qw2) if q is not None)
    p = plan_int8(x.shape[0], k, n, x.dtype, gate=qw2 is not None, row_scale=qw.block[1] == k,
                  aligned=aligned, sms=_build.sm_count(x.device.index or 0))
    return run_int8(qw, x, out, p, qw2=qw2, bias=bias, residual=residual, act_code=act_code,
                    dtype_code=dtype_code)


def launch_int8(qw, x, out, *, qw2, bias, residual, act_code: int, dtype_code: int):
    """The packed decode projection: one `qgemv` launch, counted."""
    global launches_int8
    qgemv(qw, x, out, qw2=qw2, bias=bias, residual=residual, act_code=act_code,
          dtype_code=dtype_code)
    launches_int8 += 1
    return out
