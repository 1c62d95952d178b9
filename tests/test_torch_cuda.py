"""The port's CUDA kernels against their plain versions, on a GPU.

Marked `cuda`: each test skips without a CUDA device (always the case in
the CPU container).  On the GPU machine, which has no jax:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Small ragged and aligned shapes, so both the vector and the element-load
paths of each kernel run (chip_smoke.py holds them at the serving shapes).
Tolerances: f32 rtol = atol = 1e-4 (summation order), bf16 1.6e-2 (one
output rounding step at |y| ~ 4), f64 1e-10 (summation order).  dot and
nrm2 return one number, held to out * |plain| + acc * sum |x_i y_i| (nrm2:
||x||): `acc` the accumulator's summation error (1e-7 for the f32
accumulator of f32 and bf16, 1e-14 for f64), `out` one rounding flip of
the output (2^-7 bf16, 2^-23 f32, 2^-52 f64).  A kernel that returns 0 or drops half the vector falls
outside that limit (test_sum_limit_rejects_planted_faults, on the CPU).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import blas, quant
from repro_torch.kernels import ops

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2),
       torch.float64: dict(rtol=1e-10, atol=1e-10)}
SUM_TOL = {torch.float32: (2 ** -23, 1e-7), torch.bfloat16: (2 ** -7, 1e-7),
           torch.float64: (2 ** -52, 1e-14)}
BLAS_DTYPES = [torch.float32, torch.bfloat16, torch.float64]
PROFILE_ATTEMPTS = 3


def _sum_limit(dtype, want: float, cond: float) -> float:
    out, acc = SUM_TOL[dtype]
    return out * abs(want) + acc * cond


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.Generator(device="cuda").manual_seed(0)


def _profiled_kernels(call, pattern: str, want: int) -> list[str]:
    """The name of every device kernel torch.profiler sees while `call`
    runs.  The profiler loses a kernel record now and then on the H100, so
    a profile with fewer than `want` kernels named with `pattern` is taken
    again, up to PROFILE_ATTEMPTS in all; a kernel launched no time or
    twice reads wrong in every profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if sum(pattern in name for name in names) >= want:
            break
    return names


def _rand(gen, dtype, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dtype)


def _against_plain(call, dtype):
    got = call()
    with ops.reference_mode():
        want = call()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,k,n", [(3, 37, 53), (4, 256, 512), (6, 1000, 264), (1, 64, 8)])
def test_bgemv_kernel_matches_plain(cuda, dtype, batch, k, n):
    w, w2 = _rand(cuda, dtype, k, n, std=k ** -0.5), _rand(cuda, dtype, k, n, std=k ** -0.5)
    x, bias, res = _rand(cuda, dtype, batch, k), _rand(cuda, dtype, n), _rand(cuda, dtype, batch, n)
    _against_plain(lambda: ops.bgemv(w, x, transpose_a=True), dtype)
    _against_plain(lambda: ops.bgemv(w, x, a2=w2, bias=bias, residual=res, activation="silu",
                                     transpose_a=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bgemm_kernel_matches_plain(cuda, dtype):
    a, b, b2 = (_rand(cuda, dtype, 2, 13, 37), _rand(cuda, dtype, 37, 53, std=37 ** -0.5),
                _rand(cuda, dtype, 37, 53, std=37 ** -0.5))
    bias, res = _rand(cuda, dtype, 53), _rand(cuda, dtype, 2, 13, 53)
    _against_plain(lambda: ops.bgemm(a, b, b2=b2, bias=bias, residual=res, activation="gelu"), dtype)
    _against_plain(lambda: ops.bgemm(a, b, activation="relu"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_attention_kernel_matches_plain(cuda, dtype, d):
    q, kv = _rand(cuda, dtype, 3, 5, 4, d), _rand(cuda, dtype, 3, 24, 2, d)
    kv[1, 12:] = float("nan")  # garbage past slot 1's length
    lens = torch.tensor([5] * 4 + [12] * 4 + [20] * 4, dtype=torch.int32, device="cuda")
    _against_plain(lambda: ops.flash_attention(q, kv, kv, kv_lens=lens, kv_groups=2), dtype)


def _kv_case(gen, dtype, int8, page_size, *, tq=1, h=4, kvh=2, d=64, lens=(37, 20, 9)):
    """q (B, Tq, H, D) and a dense cache (B, S, KVH, D), S = max(lens), in
    `dtype` or int8 with per-(token, head) scales, garbage past each slot's
    length (NaN values, or random int8 under NaN scales).  With page_size
    the same keys also sit in a pool under a shuffled table whose dead
    entries, like serving's, point at the trash page 0 (garbage too).
    Returns (q, cache operands, paged operands or None, kv_lens)."""
    b, s = len(lens), max(lens)
    q = _rand(gen, dtype, b, tq, h, d)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda").repeat_interleave(h)
    dense = {}
    for name in "kv":
        x = _rand(gen, torch.float32, b, s, kvh, d)
        if int8:
            qt = quant.quantize_kv(x)
            vals, sc = qt.values, qt.scales
            for i, n in enumerate(lens):
                vals[i, n:] = torch.randint(-127, 128, vals[i, n:].shape, generator=gen,
                                            device="cuda", dtype=torch.int8)
                sc[i, n:] = float("nan")
            dense[name], dense[name + "_scales"] = vals, sc
        else:
            x = x.to(dtype)
            for i, n in enumerate(lens):
                x[i, n:] = float("nan")
            dense[name] = x
    if page_size is None:
        return q, dense, None, kv_lens
    max_pages = -(-s // page_size)
    num_pages = 1 + b * max_pages + 3  # spare pages hold garbage too
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda")[:b * max_pages] + 1
    table = perm.reshape(b, max_pages).to(torch.int32)
    for i, n in enumerate(lens):
        table[i, -(-n // page_size):] = 0
    paged = {"page_table": table}
    for name, t in dense.items():
        pool = torch.full((num_pages, page_size) + tuple(t.shape[2:]), float("nan"),
                          device="cuda")
        pool = pool.to(t.dtype) if t.dtype != torch.int8 else torch.randint(
            -127, 128, pool.shape, generator=gen, device="cuda", dtype=torch.int8)
        padded = torch.zeros((b, max_pages * page_size) + tuple(t.shape[2:]),
                             dtype=t.dtype, device="cuda")
        padded[:, :s] = t
        for i, n in enumerate(lens):
            for j in range(-(-n // page_size)):
                pool[table[i, j]] = padded[i, j * page_size:(j + 1) * page_size]
        paged[name] = pool
    return q, dense, paged, kv_lens


def _attend(q, ops_kw, kv_lens, groups, **mask):
    return ops.flash_attention(q, ops_kw["k"], ops_kw["v"], kv_lens=kv_lens, kv_groups=groups,
                               k_scales=ops_kw.get("k_scales"), v_scales=ops_kw.get("v_scales"),
                               page_table=ops_kw.get("page_table"), **mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [None, 1, 4, 7, 16])
@pytest.mark.parametrize("d,kvh,tq", [(64, 2, 1), (128, 2, 1), (64, 4, 6), (16, 1, 9)])
def test_attention_kv_forms_match_plain(cuda, dtype, int8, page_size, d, kvh, tq):
    """int8 K/V and the paged pool, alone and together: GQA, D = 128, a
    prefill block (Tq > 1), page sizes 1, 4, 7 and 16.  Each form within
    tolerance of its plain version; a paged launch bitwise the dense launch
    on the cache its table gathers."""
    h = 4
    lens = (37, 20, 9) if tq < 9 else (37, 20, 10)
    q, dense, paged, kv_lens = _kv_case(cuda, dtype, int8, page_size, tq=tq, h=h, kvh=kvh,
                                        d=d, lens=lens)
    ops_kw = paged if paged is not None else dense
    _against_plain(lambda: _attend(q, ops_kw, kv_lens, h // kvh), dtype)
    if paged is not None:
        from repro_torch.kernels.attention import gather_pages
        table = paged["page_table"]
        gathered = {k: gather_pages(v, table).contiguous() for k, v in paged.items()
                    if k != "page_table"}
        assert torch.equal(_attend(q, paged, kv_lens, h // kvh),
                           _attend(q, gathered, kv_lens, h // kvh))


@pytest.mark.cuda
def test_attention_forms_count_their_launches(cuda):
    q, dense, paged, kv_lens = _kv_case(cuda, torch.bfloat16, True, 4)
    _, plain, _, _ = _kv_case(cuda, torch.bfloat16, False, None)
    ops.reset_launch_counts()
    _attend(q, dense, kv_lens, 2)
    _attend(q, paged, kv_lens, 2)
    _attend(q, plain, kv_lens, 2)
    with ops.reference_mode():
        _attend(q, paged, kv_lens, 2)
    counts = ops.launch_counts()
    assert (counts["attention"], counts["attention_int8"], counts["attention_paged"]) == (1, 2, 1)


# (route, q dtype, Tq, kv lengths): decode lengths below, at and above the
# split chunk (128); prefill blocks over two query tiles and three key tiles
ATTENTION_ROUTES = [("splitkv", torch.float32, 1, (150, 128, 9, 70)),
                    ("splitkv", torch.bfloat16, 1, (150, 128, 9, 70)),
                    ("mma", torch.bfloat16, 70, (150, 70, 133, 71)),
                    ("ffma", torch.float32, 70, (150, 70, 133, 71))]


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype,tq,lens", ATTENTION_ROUTES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [None, 7])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("groups", [1, 4])
def test_attention_route_matches_plain(cuda, route, dtype, tq, lens, int8, page_size, d, groups):
    """Each route of `kernels.attention.plan` in every form (dense, paged,
    int8, paged int8; D 16-256; G = H / KVH of 1 and 4): one launch counted
    on the planned route, within TOL of the plain version, two launches
    bitwise equal, a paged launch bitwise the dense launch on the gathered
    cache."""
    from repro_torch.kernels import attention
    h = 8
    q, dense, paged, kv_lens = _kv_case(cuda, dtype, int8, page_size, tq=tq, h=h,
                                        kvh=h // groups, d=d, lens=lens)
    ops_kw = paged if paged is not None else dense
    s = max(lens) if paged is None else paged["k"].shape[1] * paged["page_table"].shape[1]
    assert attention.plan(len(lens), tq, h, h // groups, d, s, dtype, int8).route == route
    ops.reset_launch_counts()
    got = _attend(q, ops_kw, kv_lens, groups)
    assert ops.attention_routes() == {"splitkv": 0, "mma": 0, "ffma": 0, route: 1}
    with ops.reference_mode():
        want = _attend(q, ops_kw, kv_lens, groups)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, _attend(q, ops_kw, kv_lens, groups))
    if paged is not None:
        from repro_torch.kernels.attention import gather_pages
        table = paged["page_table"]
        gathered = {k: gather_pages(v, table).contiguous() for k, v in paged.items()
                    if k != "page_table"}
        assert torch.equal(got, _attend(q, gathered, kv_lens, groups))


#: (causal, prefix_len): the causal mask, prefix-LM over 40 keys (inside
#: some query blocks' causal range, past others'), non-causal
MASKS = [dict(), dict(prefix_len=40), dict(causal=False)]
MASK_IDS = ["causal", "prefix", "noncausal"]


# the f32 route "ffma" (csrc/attention.cu): (K/V form, page size), cache
# layout; the flat layout takes the unpaged forms
FFMA_FORMS = [("dense", None), ("int8", None), ("paged", 7), ("paged", 16), ("int8", 16)]
FFMA_CASES = ([("cache", *f) for f in FFMA_FORMS]
              + [("flat", "dense", None), ("flat", "int8", None)])


def _flat_of(q, kw):
    """A cache-layout case's operands in the flat layout: q (B * H, Tq, D),
    k/v (B * KVH, S, D) and their scales, the same rows in the same order
    (flat row b * H + h reads KV row b * KVH + h // g)."""
    b, tq, h, d = q.shape
    flat = {"q": q.permute(0, 2, 1, 3).reshape(b * h, tq, d)}
    for name, t in kw.items():
        flat[name] = t.permute(0, 2, 1, 3).reshape(b * t.shape[2], t.shape[1], t.shape[3])
    return flat


@pytest.mark.cuda
@pytest.mark.parametrize("layout,form,page_size", FFMA_CASES)
@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("h,kvh", [(32, 8), (8, 1)])
@pytest.mark.parametrize("tq", [2, 33, 128])
def test_ffma_route_matches_plain(cuda, layout, form, page_size, mask, d, h, kvh, tq):
    """The f32 prefill on "ffma" in every head dim, mask, K/V form (dense,
    int8, paged at P = 7 and 16, paged int8) and layout (cache, flat), GQA
    32/8 and MQA 8/1, Tq off and on the query tile, kv lengths at and past
    Tq, NaN past them: one launch counted on "ffma" (and its layout), within
    f32 TOL of the plain version, two launches bitwise equal, a paged launch
    bitwise the dense launch on the gathered cache."""
    from repro_torch.kernels import attention
    int8 = form == "int8"
    lens = (tq + 37, tq, tq + 90)
    q, dense, paged, kv_lens = _kv_case(cuda, torch.float32, int8, page_size, tq=tq, h=h,
                                        kvh=kvh, d=d, lens=lens)
    kw = paged if paged is not None else dense
    if layout == "flat":
        flat = _flat_of(q, dense)

        def call():
            return ops.flash_attention(kv_lens=kv_lens, kv_groups=h // kvh, **flat, **mask)
    else:
        def call():
            return _attend(q, kw, kv_lens, h // kvh, **mask)
    ops.reset_launch_counts()
    got = call()
    assert ops.attention_routes() == {"splitkv": 0, "mma": 0, "ffma": 1}
    assert ops.attention_layouts()[f"ffma/{layout}"] == 1
    with ops.reference_mode():
        want = call()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert torch.equal(got, call())
    if paged is not None:
        table = paged["page_table"]
        gathered = {k: attention.gather_pages(v, table).contiguous() for k, v in paged.items()
                    if k != "page_table"}
        assert torch.equal(got, _attend(q, gathered, kv_lens, h // kvh, **mask))


@pytest.mark.cuda
def test_ffma_launch_refuses_a_tile_it_was_not_built_for(cuda):
    """The plan's tile is the head dim's; "ffma" refuses any other."""
    from repro_torch.kernels import attention
    q, dense, _, kv_lens = _kv_case(cuda, torch.float32, False, None, tq=9, h=4, kvh=2)
    p = attention.plan_for(q, dense["k"])
    for other in (p._replace(block_k=p.block_k // 2), p._replace(block_q=2 * p.block_q)):
        with pytest.raises(RuntimeError, match="ffma kernel launch failed"):
            attention.run(q, dense["k"], dense["v"], kv_lens, torch.empty_like(q), other,
                          dtype_code=ops._DTYPE_CODES[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("form,page_size", [("dense", None), ("paged", 7), ("int8", 16)])
def test_ffma_route_bits_do_not_depend_on_the_batch(cuda, form, page_size):
    """A slot's rows on "ffma" alone (a batch of 1) carry the bits they carry
    in a batch of 4."""
    h, kvh, tq = 8, 2, 100
    q, dense, paged, kv_lens = _kv_case(cuda, torch.float32, form == "int8", page_size, tq=tq,
                                        h=h, kvh=kvh, lens=(160, 131, 100, 117))
    kw = paged if paged is not None else dense
    got = _attend(q, kw, kv_lens, h // kvh)
    for i in range(4):
        one = {k: t if paged is not None and k != "page_table" else t[i:i + 1]
               for k, t in kw.items()}
        alone = _attend(q[i:i + 1], one, kv_lens[i * h:(i + 1) * h], h // kvh)
        torch.cuda.synchronize()
        assert torch.equal(got[i:i + 1], alone)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("dtype,tq", [(torch.float32, 1), (torch.bfloat16, 1),
                                      (torch.bfloat16, 5), (torch.float32, 5)])
def test_attention_bits_do_not_depend_on_the_cache_length(cuda, dtype, tq, mask):
    """A cache four times longer than every kv length (garbage past them)
    gives the bits of the same call on the cache cut to the longest, under
    every mask (the non-causal launch's visible prefix is S)."""
    lens = (100, 37, 64)
    q, dense, _, kv_lens = _kv_case(cuda, dtype, False, None, tq=tq, h=4, kvh=2, lens=lens)
    long = {}
    for name in "kv":
        t = torch.full((3, 4 * max(lens), 2, 64), float("nan"), dtype=dtype, device="cuda")
        t[:, :max(lens)] = dense[name]
        long[name] = t
    assert torch.equal(_attend(q, dense, kv_lens, 2, **mask), _attend(q, long, kv_lens, 2, **mask))


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype,tq,lens", ATTENTION_ROUTES)
@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [None, 7])
@pytest.mark.parametrize("d,groups", [(64, 1), (64, 4), (256, 8)])
def test_attention_masks_match_plain(cuda, route, dtype, tq, lens, mask, int8, page_size, d,
                                     groups):
    """Each route under the prefix-LM and non-causal masks and the causal
    one, in every form, at D = 64 (whisper; GQA) and D = 256 (paligemma's
    MQA, 8 query heads on 1 KV head): one launch counted on the planned
    route and under its mask, within TOL of the plain version, two launches
    bitwise equal, a paged launch bitwise the dense launch on the gathered
    cache.  At Tq = 1 ("splitkv", no mask code) the three masks give the
    same bits."""
    from repro_torch.kernels import attention
    h = 8
    q, dense, paged, kv_lens = _kv_case(cuda, dtype, int8, page_size, tq=tq, h=h,
                                        kvh=h // groups, d=d, lens=lens)
    ops_kw = paged if paged is not None else dense
    ops.reset_launch_counts()
    got = _attend(q, ops_kw, kv_lens, groups, **mask)
    assert ops.attention_routes() == {"splitkv": 0, "mma": 0, "ffma": 0, route: 1}
    assert {k: n for k, n in ops.attention_masks().items() if n} == {
        f"{route}/{attention.mask_name(**mask)}": 1}
    with ops.reference_mode():
        want = _attend(q, ops_kw, kv_lens, groups, **mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, _attend(q, ops_kw, kv_lens, groups, **mask))
    if paged is not None:
        table = paged["page_table"]
        gathered = {k: attention.gather_pages(v, table).contiguous() for k, v in paged.items()
                    if k != "page_table"}
        assert torch.equal(got, _attend(q, gathered, kv_lens, groups, **mask))
    if tq == 1:
        assert torch.equal(got, _attend(q, ops_kw, kv_lens, groups))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,int8,page_size,groups", [(torch.bfloat16, False, None, 1),
                                                         (torch.bfloat16, True, 16, 1),
                                                         (torch.float32, False, 7, 4)])
def test_splitkv_bits_do_not_depend_on_the_splits_a_block_streams(cuda, dtype, int8,
                                                                   page_size, groups):
    """A "splitkv" block computes each split's partials as if it were
    alone: one split a block, 3 or 64 consecutive ones give the same bits."""
    from repro_torch.kernels import attention
    h = 8
    q, dense, paged, kv_lens = _kv_case(cuda, dtype, int8, page_size, h=h, kvh=h // groups,
                                        lens=(700, 64, 1000, 129))
    kw = paged if paged is not None else dense
    p = attention.plan_for(q, kw["k"], kw.get("page_table"), int8)
    outs = []
    for per_block in (1, 3, 64):
        out = torch.empty_like(q)
        attention.run(q, kw["k"], kw["v"], kv_lens, out, p._replace(per_block=per_block),
                      dtype_code=ops._DTYPE_CODES[dtype], k_scales=kw.get("k_scales"),
                      v_scales=kw.get("v_scales"), page_table=kw.get("page_table"))
        outs.append(out)
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    torch.testing.assert_close(outs[0].float(), _attend(q, kw, kv_lens, groups).float(), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tq", [(torch.float32, 1), (torch.bfloat16, 1),
                                      (torch.bfloat16, 3), (torch.float32, 3)])
def test_attention_masks_each_head_by_its_own_length(cuda, dtype, tq):
    """The query heads of one KV head with different kv lengths (the API
    allows it): each head sees its own keys only."""
    h, kvh, s = 8, 2, 90
    q = _rand(cuda, dtype, 2, tq, h, 64)
    k, v = _rand(cuda, dtype, 2, s, kvh, 64), _rand(cuda, dtype, 2, s, kvh, 64)
    k[:, 80:] = float("nan")  # past every length
    v[:, 80:] = float("nan")
    kv_lens = torch.tensor([80, 3, 64, 65, 12, 40, 70, 5, 9, 10, 11, 12, 66, 67, 68, 80],
                           dtype=torch.int32, device="cuda")
    _against_plain(lambda: ops.flash_attention(q, k, v, kv_lens=kv_lens, kv_groups=4), dtype)


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda):
    ops.reset_launch_counts()
    w, x = _rand(cuda, torch.float32, 64, 32), _rand(cuda, torch.float32, 2, 64)
    ops.bgemv(w, x, transpose_a=True)
    ops.bgemm(x[None], w)
    ops.bgemm(x[None], w[None])  # a per-member B: the batched launch (f32: the TMA ring)
    ops.gemm(x, w)
    ops.gemv(w, x[0, :32])
    ops.dot(x[0], x[1])
    ops.nrm2(x[0])
    ops.axpy(2.0, x[0], x[1])
    qt, qn = (quant.quantize(w, quant.QuantSpec(16, None, transpose=t)) for t in (True, False))
    ops.bgemv(qt, x, transpose_a=True)
    ops.bgemm(x[None], qt)
    ops.gemm(x, qn)
    ops.gemv(quant.quantize(w.t().contiguous()), x[0])
    with ops.reference_mode():
        ops.bgemv(w, x, transpose_a=True)
        ops.gemm(x, w)
        ops.dot(x[0], x[1])
        ops.bgemv(qt, x, transpose_a=True)
        ops.gemm(x, qn)
    # the packed f32 products (int8 rows of 64 and 32 bytes) on the f32 ring
    assert ops.launch_counts() == {"bgemv": 1, "bgemm": 1, "attention": 0,
                                   "attention_paged": 0, "attention_int8": 0, "gemm": 1,
                                   "gemv": 1, "blas1_reduce": 2, "blas1_axpy": 1,
                                   "bgemv_int8": 1, "bgemv_broadcast_t": 1,
                                   "bgemv_broadcast_n": 0, "bgemv_batched_t": 0,
                                   "bgemv_batched_n": 0, "bgemv_members": 0,
                                   "gemv_int8": 1, "gemm_int8": 2,
                                   "rwkv6": 0, "mamba2_ssd": 0, "gemm_wgmma": 0,
                                   "gemm_dmma": 0, "gemm_ffma_sm90": 2, "gemm_ffma": 0,
                                   "gemm_wgmma_staged": 0, "gemm_dmma_copy8": 0,
                                   "gemm_ffma_sm90_staged": 0, "gemm_ffma_sm90_odd": 0,
                                   "bgemm_wgmma": 0, "bgemm_dmma": 0, "bgemm_ffma_sm90": 2,
                                   "bgemm_ffma": 0, "bgemm_wgmma_staged": 0,
                                   "bgemm_dmma_copy8": 0, "bgemm_ffma_sm90_staged": 0,
                                   "bgemm_ffma_sm90_odd": 0,
                                   "bgemm_batched": 1,
                                   "bgemm_batched_int8": 0, "bgemm_batched_staged": 0,
                                   "bgemm_batched_wgmma": 0, "bgemm_batched_dmma": 0,
                                   "bgemm_batched_ffma_sm90": 1, "bgemm_batched_ffma": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("m,k,n", [(13, 37, 53), (128, 64, 256), (130, 9, 67), (1, 300, 5),
                                   (0, 8, 3)])
def test_gemm_kernel_matches_plain(cuda, dtype, m, k, n):
    """Ragged and whole tiles, K below one k-step, a single row, no rows."""
    a, b, b2 = (_rand(cuda, dtype, m, k), _rand(cuda, dtype, k, n, std=k ** -0.5),
                _rand(cuda, dtype, k, n, std=k ** -0.5))
    bias, res = _rand(cuda, dtype, n), _rand(cuda, dtype, m, n)
    _against_plain(lambda: ops.gemm(a, b), dtype)
    _against_plain(lambda: ops.gemm(a, b, b2=b2, bias=bias, residual=res, activation="silu"),
                   dtype)
    _against_plain(lambda: ops.gemm(a, b, bias=bias, residual=res, activation="gelu"), dtype)
    _against_plain(lambda: ops.gemm(a, b, b2=b2, activation="relu"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("m,n", [(37, 53), (256, 512), (1000, 264), (5, 4099), (3, 16384),
                                 (0, 16)])
def test_gemv_kernel_matches_plain(cuda, dtype, m, n):
    """Aligned rows (16-byte loads), ragged rows (element loads), few long
    rows (several warps a row), and an x that starts off 16 bytes."""
    a = _rand(cuda, dtype, m, n, std=n ** -0.5)
    xbuf = _rand(cuda, dtype, n + 1)
    _against_plain(lambda: ops.gemv(a, xbuf[:n]), dtype)
    _against_plain(lambda: ops.gemv(a, xbuf[1:]), dtype)


def _against_plain_sum(call, dtype, cond):
    """dot / nrm2: |kernel - plain| within _sum_limit, which a zero result
    would not meet."""
    got = call()
    with ops.reference_mode():
        want = call()
    torch.cuda.synchronize()
    assert got.shape == () and got.dtype == dtype
    want = want.double().item()
    limit = _sum_limit(dtype, want, cond)
    assert abs(got.double().item() - want) <= limit < abs(want), (got, want, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("n", [1, 37, 4096, 100003])
def test_blas1_kernels_match_plain(cuda, dtype, n):
    """dot, nrm2 and axpy on aligned vectors and on views that start one
    element in (element loads)."""
    buf_x, buf_y = _rand(cuda, dtype, n + 1), _rand(cuda, dtype, n + 1)
    for x, y in ((buf_x[:n], buf_y[:n]), (buf_x[1:], buf_y[1:])):
        cond = (x.double() * y.double()).abs().sum().item()
        _against_plain_sum(lambda: ops.dot(x, y), dtype, cond)
        _against_plain_sum(lambda: ops.nrm2(x), dtype, x.double().norm().item())
        _against_plain(lambda: ops.axpy(-1.75, x, y), dtype)


@pytest.mark.parametrize("dtype", BLAS_DTYPES)
def test_sum_limit_rejects_planted_faults(dtype):
    """On the CPU (plain versions): the dot/nrm2 limit above passes the
    result but not a zero result or one that drops half the vector."""
    gen = torch.Generator().manual_seed(1)
    n = 100003
    x, y = (torch.randn(n, generator=gen).to(dtype) for _ in range(2))
    cases = ((ops.dot, (x, y), (x.double() * y.double()).abs().sum().item()),
             (ops.nrm2, (x,), x.double().norm().item()))
    for fn, args, cond in cases:
        want = fn(*args).double().item()
        half = fn(*(a[: n // 2] for a in args)).double().item()
        limit = _sum_limit(dtype, want, cond)
        assert abs(want) > limit and abs(half - want) > limit, (fn, want, half, limit)


# --------------------------------------------------------------------------
# packed int8 weights (csrc/qgemv.cu, gemm.cu's int8-B variant)
# --------------------------------------------------------------------------

# (k, n, spec): the serving spec, per-chunk scales (qn a multiple of 16), an
# awkward _fit_block block with a ragged K (element loads), tiny blocks
PACKED_SPECS = [(256, 96, quant.QuantSpec(64, None)), (128, 70, quant.QuantSpec(16, 32)),
                (61, 45, quant.QuantSpec(61, None)), (50, 33, quant.QuantSpec(7, 5))]


def _packed(gen, k, n, spec, transpose):
    w = _rand(gen, torch.float32, k, n, std=k ** -0.5)
    return quant.quantize(w, quant.QuantSpec(spec.block_m, spec.block_n, transpose=transpose))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("batch", [1, 4, 6])
@pytest.mark.parametrize("k,n,spec", PACKED_SPECS)
def test_packed_bgemv_kernel_matches_plain(cuda, dtype, batch, k, n, spec):
    """Output-major rows: one row scale, per-chunk scales and element loads;
    the dual gate and every epilogue stage; batches below, at and above 4."""
    qw, qw2 = (_packed(cuda, k, n, spec, True) for _ in range(2))
    x, bias, res = _rand(cuda, dtype, batch, k), _rand(cuda, dtype, n), _rand(cuda, dtype, batch, n)
    _against_plain(lambda: ops.bgemv(qw, x, transpose_a=True), dtype)
    _against_plain(lambda: ops.bgemv(qw, x, a2=qw2, bias=bias, residual=res,
                                     activation="silu", transpose_a=True), dtype)
    _against_plain(lambda: ops.bgemv(qw, x, bias=bias, activation="gelu", transpose_a=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("k,n,spec", PACKED_SPECS)
def test_packed_gemv_kernel_matches_plain(cuda, dtype, k, n, spec):
    """BLAS gemv over a packed (m, n) A, and an x that starts off 16 bytes."""
    qa = _packed(cuda, n, k, spec, False)  # stored (n, k): y (n,) = A x (k,)
    xbuf = _rand(cuda, dtype, k + 1)
    _against_plain(lambda: ops.gemv(qa, xbuf[:k]), dtype)
    _against_plain(lambda: ops.gemv(qa, xbuf[1:]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("m,k,n,spec", [(13, 37, 53, quant.QuantSpec(37, None)),
                                        (130, 64, 67, quant.QuantSpec(8, 16)),
                                        (9, 40, 130, quant.QuantSpec(8, None)),
                                        (20, 33, 29, quant.QuantSpec(11, 3)),
                                        (33, 40, 132, quant.QuantSpec(8, None)),
                                        (7, 68, 50, quant.QuantSpec(10, 17)),
                                        (0, 16, 8, quant.QuantSpec(8, None))])
def test_packed_gemm_kernel_matches_plain(cuda, dtype, transpose, m, k, n, spec):
    """int8 B in the "nk" and "kn" layouts: ragged tiles, awkward blocks."""
    qb, qb2 = (_packed(cuda, k, n, spec, transpose) for _ in range(2))
    a, bias, res = _rand(cuda, dtype, m, k), _rand(cuda, dtype, n), _rand(cuda, dtype, m, n)
    _against_plain(lambda: ops.gemm(a, qb), dtype)
    _against_plain(lambda: ops.gemm(a, qb, b2=qb2, bias=bias, residual=res,
                                    activation="silu"), dtype)
    if dtype != torch.float64:
        a3, r3 = _rand(cuda, dtype, 2, 7, k), _rand(cuda, dtype, 2, 7, n)
        _against_plain(lambda: ops.bgemm(a3, qb, bias=bias, residual=r3, activation="gelu"),
                       dtype)


@pytest.mark.cuda
def test_quantize_on_the_card_is_bitwise_the_cpu(cuda):
    w = _rand(cuda, torch.bfloat16, 300, 200)
    w[:64] = 0  # an all-zero block
    for spec in (quant.QuantSpec(64, None, transpose=True), quant.QuantSpec(7, 16)):
        got, want = quant.quantize(w, spec), quant.quantize(w.cpu(), spec)
        assert torch.equal(got.values.cpu(), want.values)
        assert torch.equal(got.scales.cpu(), want.scales)


@pytest.mark.cuda
def test_packed_matmul_fused_routes_through_the_packed_kernels(cuda):
    qw = _packed(cuda, 64, 48, quant.QuantSpec(16, None), True)
    ops.reset_launch_counts()
    for shape in ((4, 1, 64), (2, 5, 64), (5, 64)):
        x = _rand(cuda, torch.bfloat16, *shape)
        _against_plain(lambda: blas.matmul_fused(x, qw, activation="relu"), torch.bfloat16)
    counts = ops.launch_counts()
    assert (counts["bgemv_int8"], counts["gemm_int8"]) == (1, 2)
    assert counts["bgemv"] == counts["bgemm"] == counts["gemm"] == 0


@pytest.mark.cuda
def test_int8_smoke_serve_matches_plain_path(cuda):
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config("stablelm-1.6b", "smoke")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab, size=(n,), dtype=np.int32) for n in (8, 14, 5, 11, 8)]
    kw = dict(batch=2, gen_lens=[3, 7, 4, 6, 5], eos=-1, prompts=prompts, quantize="int8",
              params=tf.init_params(cfg, 0, "cuda"), verbose=False, device="cuda")
    ops.reset_launch_counts()
    got = serve("stablelm-1.6b", "smoke", **kw)
    counts = ops.launch_counts()
    with ops.reference_mode():
        want = serve("stablelm-1.6b", "smoke", **kw)
    assert got["outputs"] == want["outputs"]
    assert counts["bgemv_int8"] > 0 and counts["gemm_int8"] > 0
    assert counts["bgemv"] == counts["bgemm"] == 0


# the packed GEMV redesign (csrc/qgemv.cu, kernels/bgemv.py::plan_int8) at
# the served decode shapes: stablelm-1.6b's q/k/v/o, gate+up and down, and
# 2040 outputs (not a multiple of the 32 / 16 rows a block owns); the
# serving spec's one scale a row, per-chunk scales (qn = 64) and element
# loads (qn = 8, not a multiple of 16)
SERVED_INT8 = [(2048, 2048, False), (2048, 5632, True), (5632, 2048, False),
               (2048, 2040, False), (2048, 2040, True)]
INT8_MODES = {"row scale": (64, None), "chunk scales": (64, 64), "element loads": (40, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("batch", [1, 4, 5, 9])
@pytest.mark.parametrize("mode", sorted(INT8_MODES))
@pytest.mark.parametrize("k,n,gate", SERVED_INT8)
def test_qgemv_matches_plain_at_the_served_shapes(cuda, dtype, batch, mode, k, n, gate):
    """Every scale mode with the gate (silu) or bias + gelu, residual +
    relu, or no epilogue; f32, bf16 and f64 x; batches of one, one chunk,
    and two and three chunks of 4."""
    spec = quant.QuantSpec(*INT8_MODES[mode], transpose=True)
    w = _rand(cuda, torch.float32, k, n, std=k ** -0.5)
    qw = quant.quantize(w, spec)
    qw2 = quant.quantize(_rand(cuda, torch.float32, k, n, std=k ** -0.5), spec) if gate else None
    x, bias, res = _rand(cuda, dtype, batch, k), _rand(cuda, dtype, n), _rand(cuda, dtype, batch, n)
    if gate:
        _against_plain(lambda: ops.bgemv(qw, x, a2=qw2, activation="silu", transpose_a=True), dtype)
    else:
        _against_plain(lambda: ops.bgemv(qw, x, transpose_a=True), dtype)
        _against_plain(lambda: ops.bgemv(qw, x, bias=bias, activation="gelu", transpose_a=True),
                       dtype)
        _against_plain(lambda: ops.bgemv(qw, x, residual=res, activation="relu",
                                         transpose_a=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("k,n,gate", SERVED_INT8[:3])
def test_qgemv_every_split_matches_plain(cuda, dtype, k, n, gate):
    """Plans other than the chosen one (1 to 16 K slices) at batch 4, on the
    route the plan takes (bf16: tensor cores): each within TOL of the plain
    version and its launch bitwise a second one."""
    from repro_torch.kernels import bgemv
    spec = quant.QuantSpec(64, None, transpose=True)
    qw = quant.quantize(_rand(cuda, torch.float32, k, n, std=k ** -0.5), spec)
    qw2 = quant.quantize(_rand(cuda, torch.float32, k, n, std=k ** -0.5), spec) if gate else None
    x = _rand(cuda, dtype, 4, k)
    act = "silu" if gate else None
    with ops.reference_mode():
        want = ops.bgemv(qw, x, a2=qw2, activation=act, transpose_a=True)
    route = bgemv.int8_route(k, dtype, True)
    for splits in (1, 2, 3, 4, 8, 16):
        cols = k if splits == 1 else bgemv._cdiv(bgemv._cdiv(k, splits), 16) * 16
        p = bgemv.Int8Plan(route, bgemv.INT8_ROWS[(route, gate)], bgemv._cdiv(k, cols), cols)
        if p.x_bytes(4, dtype) > bgemv.INT8_MAX_X_BYTES:
            continue
        outs = []
        for _ in range(2):
            out = torch.empty(4, n, dtype=dtype, device="cuda")
            bgemv.run_int8(qw, x, out, p, qw2=qw2, bias=None, residual=None,
                           act_code=ops._ACTS[act], dtype_code=ops._DTYPE_CODES[dtype])
            outs.append(out)
        torch.cuda.synchronize()
        torch.testing.assert_close(outs[0].float(), want.float(), **TOL[dtype])
        assert torch.equal(outs[0], outs[1]), p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_blas_gemv_at_16384_matches_plain_and_repeats_its_bits(cuda, dtype):
    """The BLAS gemv 16384^2: f32 x in one K slice, f64 x in slices (128 KB
    of x does not fit a block's shared memory)."""
    qa = quant.quantize(_rand(cuda, torch.float32, 16384, 16384, std=16384 ** -0.5),
                        quant.QuantSpec(64, None))
    x = _rand(cuda, dtype, 16384)
    got = ops.gemv(qa, x)
    with ops.reference_mode():
        want = ops.gemv(qa, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL[dtype])
    assert torch.equal(got, ops.gemv(qa, x))


@pytest.mark.cuda
def test_qgemv_takes_packed_rows_off_16_bytes(cuda):
    """Packed values viewed from one byte into a buffer plan the CUDA-core
    body (element loads); bf16 x under the serving spec otherwise runs on
    the tensor cores."""
    from repro_torch.kernels import bgemv
    spec = quant.QuantSpec(64, None, transpose=True)
    qw = quant.quantize(_rand(cuda, torch.float32, 1024, 128), spec)
    buf = torch.empty(qw.values.numel() + 1, dtype=torch.int8, device="cuda")
    buf[1:] = qw.values.reshape(-1)
    off = quant.QuantizedTensor(buf[1:].view(qw.values.shape), qw.scales, qw.block,
                                qw.transposed)
    assert off.values.data_ptr() % 16 and bgemv.plan_int8(4, 1024, 128, torch.bfloat16,
                                                          aligned=False).route == "ffma"
    x = _rand(cuda, torch.bfloat16, 4, 1024)
    _against_plain(lambda: ops.bgemv(off, x, transpose_a=True), torch.bfloat16)
    _against_plain(lambda: ops.bgemv(qw, x, transpose_a=True), torch.bfloat16)


@pytest.mark.cuda
def test_qgemv_launch_refuses_a_plan_it_does_not_take(cuda):
    from repro_torch.kernels import bgemv
    spec = quant.QuantSpec(64, None, transpose=True)
    qw = quant.quantize(_rand(cuda, torch.float32, 1024, 64), spec)
    x, out = _rand(cuda, torch.float32, 4, 1024), torch.empty(4, 64, device="cuda")
    bad = (bgemv.Int8Plan("ffma", 32, 2, 500), bgemv.Int8Plan("ffma", 32, 2, 256),
           bgemv.Int8Plan("ffma", 32, 1, 5000), bgemv.Int8Plan("tc", 64, 1, 1024))  # f32 x
    for p in bad:
        with pytest.raises(RuntimeError, match="qgemv kernel launch failed"):
            bgemv.run_int8(qw, x, out, p, qw2=None, bias=None, residual=None, act_code=0,
                           dtype_code=0)


@pytest.mark.cuda
def test_qgemv_leaks_no_memory(cuda):
    qw = quant.quantize(_rand(cuda, torch.float32, 5632, 2048),
                        quant.QuantSpec(64, None, transpose=True))
    x = _rand(cuda, torch.bfloat16, 4, 5632)
    ops.bgemv(qw, x, transpose_a=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(5):
        ops.bgemv(qw, x, transpose_a=True)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


# --------------------------------------------------------------------------
# rwkv6: the chunked WKV6 kernel
# --------------------------------------------------------------------------

def _wkv6_case(gen, dtype, bh, t, kk, with_s0, strong=False):
    """r/k/v in `dtype`, w_log/u/s0 f32: the log-decay -exp(U(-6, 0)) (the
    model's form), or near the -20 clamp when `strong`."""
    r, k, v = (_rand(gen, dtype, bh, t, kk) for _ in range(3))
    if strong:
        w = -15.0 - 5.0 * torch.rand(bh, t, kk, generator=gen, device="cuda")
    else:
        w = -torch.exp(-6.0 * torch.rand(bh, t, kk, generator=gen, device="cuda"))
    u = _rand(gen, torch.float32, bh, kk, std=0.1)
    s0 = _rand(gen, torch.float32, bh, kk, kk) if with_s0 else None
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,kk,chunk", [(4, 64, 64, 32), (3, 100, 64, 32), (2, 5, 16, 8),
                                           (5, 37, 16, 8), (2, 48, 32, 16), (1, 1, 64, 32),
                                           (2, 300, 64, 32)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_kernel_matches_plain(cuda, dtype, bh, t, kk, chunk, with_s0):
    """y within the r/k/v dtype's tolerance, the final state within f32's
    (bf16 r/k/v with f32 w, u and state is the full-width model's mix)."""
    r, k, v, w, u, s0 = _wkv6_case(cuda, dtype, bh, t, kk, with_s0)
    got_y, got_s = ops.rwkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    with ops.reference_mode():
        want_y, want_s = ops.rwkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    torch.cuda.synchronize()
    assert got_y.dtype == dtype and got_s.dtype == torch.float32
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    torch.testing.assert_close(got_y.float(), want_y.float(), **TOL[dtype])
    torch.testing.assert_close(got_s, want_s, **TOL[torch.float32])


@pytest.mark.cuda
def test_rwkv6_kernel_strong_decay_stays_finite(cuda):
    r, k, v, w, u, s0 = _wkv6_case(cuda, torch.bfloat16, 8, 128, 64, True, strong=True)
    got_y, got_s = ops.rwkv6(r, k, v, w, u, s0=s0)
    with ops.reference_mode():
        want_y, want_s = ops.rwkv6(r, k, v, w, u, s0=s0)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    torch.testing.assert_close(got_y.float(), want_y.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(got_s, want_s, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bh,t,kk,chunk,with_s0,strong", [
    (torch.bfloat16, 128, 128, 64, 32, False, False), (torch.bfloat16, 128, 128, 64, 32, True, False),
    (torch.bfloat16, 32, 4096, 64, 32, True, False), (torch.bfloat16, 1, 4096, 64, 32, True, False),
    (torch.bfloat16, 1, 4096, 64, 32, False, True), (torch.bfloat16, 128, 100, 64, 32, True, False),
    (torch.float32, 16, 10, 16, 8, True, False), (torch.bfloat16, 128, 128, 64, 32, True, True),
    (torch.float32, 1, 1, 64, 32, True, False)])
def test_rwkv6_kernel_at_the_chip_smoke_shapes_repeats_its_bits(cuda, dtype, bh, t, kk, chunk,
                                                                 with_s0, strong):
    """chip_smoke's WKV6 cases (and BH = 1 at T = 4096): within TOL of the
    plain version, and a second launch gives the same bits (no atomics:
    every sum has one order)."""
    r, k, v, w, u, s0 = _wkv6_case(cuda, dtype, bh, t, kk, with_s0, strong=strong)
    got_y, got_s = ops.rwkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    again_y, again_s = ops.rwkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    with ops.reference_mode():
        want_y, want_s = ops.rwkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_y.float(), want_y.float(), **TOL[dtype])
    torch.testing.assert_close(got_s, want_s, **TOL[torch.float32])
    assert torch.equal(got_y, again_y) and torch.equal(got_s, again_s)


@pytest.mark.cuda
def test_rwkv6_kernel_leaks_no_memory(cuda):
    r, k, v, w, u, s0 = _wkv6_case(cuda, torch.bfloat16, 32, 4096, 64, True)
    ops.rwkv6(r, k, v, w, u, s0=s0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(5):
        ops.rwkv6(r, k, v, w, u, s0=s0)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_rwkv6_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u, _ = _wkv6_case(cuda, torch.float32, 2, 8, 128, False)
    with pytest.raises(NotImplementedError, match="K, V <= 64"):
        ops.rwkv6(r, k, v, w, u)
    r, k, v, w, u, _ = _wkv6_case(cuda, torch.float32, 2, 80, 16, False)
    with pytest.raises(NotImplementedError, match="chunk"):
        ops.rwkv6(r, k, v, w, u, chunk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 1])
def test_rwkv_model_routes_one_wkv6_launch_a_layer_a_prefill(cuda, batch):
    """The smoke rwkv model on the card: each prefill launches the WKV6
    kernel once a layer and every projection on bgemm; a decode step
    launches no WKV6 kernel and every projection on bgemv.  Batch 1 too,
    where the head split of the prefill's activations is a strided view."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config("rwkv6-1.6b", "smoke")
    params = tf.init_params(cfg, 0, "cuda")
    cache = tf.init_cache(cfg, batch, 32, device="cuda")
    toks = torch.randint(3, cfg.vocab, (batch, 11), dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    _, cache = tf.prefill(params, toks, cache, cfg)
    after_prefill = ops.launch_counts()
    _, cache = tf.decode_step(params, toks[:, :1], cache, cfg)
    after_decode = ops.launch_counts()
    n = cfg.n_layers
    assert (after_prefill["rwkv6"], after_prefill["bgemm"], after_prefill["bgemv"]) == (n, 10 * n, 0)
    assert (after_decode["rwkv6"], after_decode["bgemm"], after_decode["bgemv"]) == (n, 10 * n, 10 * n)
    assert after_decode["attention"] == 0


# --------------------------------------------------------------------------
# mamba2: the chunked SSD kernel
# --------------------------------------------------------------------------

def _ssd_case(gen, dtype, bh, t, p, n, with_h0, strong=False):
    """x/b/c in `dtype`, a_log/h0 f32: the log-decay -exp(N(0, 1)) * 0.3
    (the model's -exp(A) * dt), or down to -40 a step when `strong`."""
    x = _rand(gen, dtype, bh, t, p)
    b, c = (_rand(gen, dtype, bh, t, n, std=0.5) for _ in range(2))
    if strong:
        a = -40.0 * torch.rand(bh, t, generator=gen, device="cuda")
    else:
        a = -torch.exp(torch.randn(bh, t, generator=gen, device="cuda")) * 0.3
    h0 = _rand(gen, torch.float32, bh, n, p) if with_h0 else None
    return x, a, b, c, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,p,n,chunk", [(4, 128, 64, 64, 64), (3, 100, 64, 64, 64),
                                             (2, 10, 16, 16, 8), (5, 37, 16, 16, 8),
                                             (2, 48, 8, 16, 16), (2, 70, 24, 40, 32),
                                             (1, 1, 64, 64, 64), (2, 300, 64, 64, 64)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba2_ssd_kernel_matches_plain(cuda, dtype, bh, t, p, n, chunk, with_h0):
    """y within the x/b/c dtype's tolerance, the final state within f32's;
    N != P and P not a multiple of the kernel's 16-column slice included."""
    x, a, b, c, h0 = _ssd_case(cuda, dtype, bh, t, p, n, with_h0)
    ops.reset_launch_counts()
    got_y, got_h = ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk)
    with ops.reference_mode():
        want_y, want_h = ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mamba2_ssd"] == 1
    assert got_y.dtype == dtype and got_h.dtype == torch.float32
    assert tuple(got_h.shape) == (bh, n, p)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    torch.testing.assert_close(got_y.float(), want_y.float(), **TOL[dtype])
    torch.testing.assert_close(got_h, want_h, **TOL[torch.float32])


@pytest.mark.cuda
def test_mamba2_ssd_kernel_strong_decay_stays_finite(cuda):
    x, a, b, c, h0 = _ssd_case(cuda, torch.bfloat16, 8, 128, 64, 64, True, strong=True)
    got_y, got_h = ops.mamba2_ssd(x, a, b, c, h0=h0)
    with ops.reference_mode():
        want_y, want_h = ops.mamba2_ssd(x, a, b, c, h0=h0)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    torch.testing.assert_close(got_y.float(), want_y.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(got_h, want_h, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bh,t,p,n,chunk,with_h0,strong", [
    (torch.bfloat16, 256, 128, 64, 64, 64, False, False),
    (torch.bfloat16, 256, 128, 64, 64, 64, True, False),
    (torch.bfloat16, 64, 4096, 64, 64, 64, True, False),
    (torch.bfloat16, 256, 100, 64, 64, 64, True, False),
    (torch.float32, 32, 10, 16, 16, 8, True, False),
    (torch.bfloat16, 256, 128, 64, 64, 64, True, True),
    (torch.bfloat16, 1, 4096, 64, 64, 64, False, True),
    (torch.float32, 1, 1, 64, 64, 64, True, False)])
def test_mamba2_ssd_kernel_at_the_chip_smoke_shapes_repeats_its_bits(cuda, dtype, bh, t, p, n,
                                                                      chunk, with_h0, strong):
    """chip_smoke's SSD cases (and BH = 1 at T = 4096, T = 1): within TOL of
    the plain version, a second launch gives the same bits (no atomics:
    every sum has one order), one ops launch and three device launches (the
    states, the scan, the outputs) a call."""
    from repro_torch.kernels import mamba2
    x, a, b, c, h0 = _ssd_case(cuda, dtype, bh, t, p, n, with_h0, strong=strong)
    ops.reset_launch_counts()
    got_y, got_h = ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk)
    assert ops.launch_counts()["mamba2_ssd"] == 1
    names = _profiled_kernels(lambda: ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk),
                              "ssd_", mamba2.DEVICE_LAUNCHES)
    assert sum("ssd_" in name for name in names) == mamba2.DEVICE_LAUNCHES
    again_y, again_h = ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk)
    with ops.reference_mode():
        want_y, want_h = ops.mamba2_ssd(x, a, b, c, h0=h0, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_y.float(), want_y.float(), **TOL[dtype])
    torch.testing.assert_close(got_h, want_h, **TOL[torch.float32])
    assert torch.equal(got_y, again_y) and torch.equal(got_h, again_h)


@pytest.mark.cuda
def test_mamba2_ssd_kernel_leaks_no_memory(cuda):
    x, a, b, c, h0 = _ssd_case(cuda, torch.bfloat16, 64, 4096, 64, 64, True)
    ops.mamba2_ssd(x, a, b, c, h0=h0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(5):
        ops.mamba2_ssd(x, a, b, c, h0=h0)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_mamba2_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, a, b, c, _ = _ssd_case(cuda, torch.float32, 2, 8, 128, 16, False)
    with pytest.raises(NotImplementedError, match="P <= 64"):
        ops.mamba2_ssd(x, a, b, c)
    x, a, b, c, _ = _ssd_case(cuda, torch.float32, 2, 8, 16, 96, False)
    with pytest.raises(NotImplementedError, match="N <= 64"):
        ops.mamba2_ssd(x, a, b, c)
    x, a, b, c, _ = _ssd_case(cuda, torch.float32, 2, 160, 16, 16, False)
    with pytest.raises(NotImplementedError, match="chunk"):
        ops.mamba2_ssd(x, a, b, c, chunk=128)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 1])
def test_zamba_model_routes_one_ssd_launch_a_layer_a_prefill(cuda, batch):
    """The smoke zamba2 model on the card: each prefill launches the SSD
    kernel once a Mamba2 block, and every projection on bgemm (2 a block, 6
    a shared-block occurrence); a decode step launches no SSD kernel and
    every projection on bgemv; the LoRA merges run on gemm every forward.
    Batch 1 too, where the head split of the prefill's activations is a
    strided view."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import get_config
    cfg = get_config("zamba2-1.2b", "smoke")
    params = tf.init_params(cfg, 0, "cuda")
    cache = tf.init_cache(cfg, batch, 32, device="cuda")
    toks = torch.randint(3, cfg.vocab, (batch, 11), dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    _, cache = tf.prefill(params, toks, cache, cfg)
    after_prefill = ops.launch_counts()
    _, cache = tf.decode_step(params, toks[:, :1], cache, cfg)
    after_decode = ops.launch_counts()
    n, occ = cfg.n_layers, cfg.n_layers // cfg.ssm.shared_attn_every
    proj = 2 * n + 6 * occ
    assert (after_prefill["mamba2_ssd"], after_prefill["bgemm"], after_prefill["bgemv"],
            after_prefill["gemm"], after_prefill["attention"]) == (n, proj, 0, 3 * occ, occ)
    assert (after_decode["mamba2_ssd"], after_decode["bgemm"], after_decode["bgemv"],
            after_decode["gemm"], after_decode["attention"]) == (n, proj, proj, 6 * occ,
                                                                 2 * occ)


# --------------------------------------------------------------------------
# the tensor-core GEMM (csrc/gemm_sm90.cu): the "wgmma" route of gemm.plan
# --------------------------------------------------------------------------

# (activation, bias, gate, residual): each epilogue stage alone and combined
TC_EPILOGUES = [(None, False, False, False), (None, True, False, False),
                ("silu", False, True, False), (None, False, False, True),
                ("gelu", True, False, True), ("relu", True, True, True)]


def _tc_operands(gen, batch, m, k, n, epi, weights=None):
    """a (batch, m, k) bf16 and ops keywords for one epilogue; weights(k, n)
    makes B (and B2), by default dense bf16 at the model's fan_in^-0.5."""
    act, bias, gate, res = epi
    make = weights or (lambda: _rand(gen, torch.bfloat16, k, n, std=k ** -0.5))
    a, b = _rand(gen, torch.bfloat16, batch, m, k), make()
    kw = dict(activation=act)
    if gate:
        kw["b2"] = make()
    if bias:
        kw["bias"] = _rand(gen, torch.bfloat16, n)
    if res:
        kw["residual"] = _rand(gen, torch.bfloat16, batch, m, n)
    return a, b, kw


ROUTE_KEYS = ("gemm_wgmma", "gemm_ffma_sm90", "gemm_ffma", "bgemm_wgmma", "bgemm_ffma_sm90",
              "bgemm_ffma")


def _routes(**nonzero):
    """launch_counts()'s gemm and bgemm routes but "dmma"; with keywords,
    whether they equal those counts and zero elsewhere."""
    c = ops.launch_counts()
    got = {k: c[k] for k in ROUTE_KEYS}
    return got if not nonzero else got == {k: nonzero.get(k, 0) for k in ROUTE_KEYS}


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("batch,m,k,n", [(4, 127, 256, 192),   # ragged M: 4 x 127 rows
                                         (2, 33, 72, 136),     # K = 72, not a multiple of 64
                                         (3, 40, 512, 8),      # N = 8
                                         (1, 1, 2048, 264),    # M = 1 (K split)
                                         (4, 128, 2048, 64)])  # the split-K shape
def test_wgmma_route_matches_plain(cuda, epi, batch, m, k, n):
    """bgemm over batch * m rows and gemm over the same rows as a 2-D A, each
    one launch on the wgmma route, within bf16 TOL of the plain version."""
    from repro_torch.kernels import gemm
    a, b, kw = _tc_operands(cuda, batch, m, k, n, epi)
    assert gemm.plan(batch * m, k, n, torch.bfloat16, gate="b2" in kw).route == "wgmma"
    ops.reset_launch_counts()
    _against_plain(lambda: ops.bgemm(a, b, **kw), torch.bfloat16)
    kw2 = dict(kw, residual=kw["residual"].view(batch * m, n)) if "residual" in kw else kw
    _against_plain(lambda: ops.gemm(a.view(batch * m, k), b, **kw2), torch.bfloat16)
    assert _routes(gemm_wgmma=1, bgemm_wgmma=1), _routes()


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True])
def test_wgmma_split_k_is_deterministic(cuda, gate):
    """512 x 2048 -> 64 (rwkv's decay LoRA) splits K; the slices are summed
    in a fixed order, so two launches on the same inputs give the same bits."""
    from repro_torch.kernels import gemm
    epi = ("silu", True, gate, True)
    a, b, kw = _tc_operands(cuda, 4, 128, 2048, 64, epi)
    assert gemm.plan(512, 2048, 64, torch.bfloat16, gate=gate).splits > 1
    first, second = ops.bgemm(a, b, **kw), ops.bgemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _against_plain(lambda: ops.bgemm(a, b, **kw), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("batch,m,k,n,block", [(4, 127, 256, 192, 64), (4, 128, 2048, 64, 64),
                                               (2, 33, 80, 136, 8), (1, 1, 2048, 264, 64)])
def test_wgmma_int8_nk_matches_plain(cuda, epi, batch, m, k, n, block):
    """int8 B stored output-major with one scale block across K (the layout
    of serve --quantize int8), one scale every `block` columns or fewer
    (264 -> 44), on the wgmma route."""
    from repro_torch.kernels import gemm
    spec = quant.QuantSpec(block_m=block, block_n=None, transpose=True)

    def weights():
        return quant.quantize(_rand(cuda, torch.float32, k, n, std=k ** -0.5), spec)

    a, qb, kw = _tc_operands(cuda, batch, m, k, n, epi, weights)
    assert gemm.packed_layout(qb) == "nk"
    assert gemm.plan(batch * m, k, n, torch.bfloat16, gate="b2" in kw,
                     packed_layout="nk").route == "wgmma"
    ops.reset_launch_counts()
    _against_plain(lambda: ops.bgemm(a, qb, **kw), torch.bfloat16)
    assert _routes()["bgemm_wgmma"] == 1 and ops.launch_counts()["gemm_int8"] == 1


@pytest.mark.cuda
def test_unaligned_bf16_takes_staged_wgmma(cuda):
    """K % 8 != 0, and an aligned shape whose A starts 2 bytes off a 16-byte
    boundary: both run the tensor-core kernel on staged operands, and the
    counts say so."""
    b, b37 = _rand(cuda, torch.bfloat16, 64, 128, std=0.125), _rand(cuda, torch.bfloat16, 37, 128)
    ragged = _rand(cuda, torch.bfloat16, 2, 5, 37)
    buf = _rand(cuda, torch.bfloat16, 2 * 5 * 64 + 1)
    shifted = buf[1:].view(2, 5, 64)
    ops.reset_launch_counts()
    _against_plain(lambda: ops.bgemm(ragged, b37), torch.bfloat16)
    _against_plain(lambda: ops.bgemm(shifted, b), torch.bfloat16)
    assert _routes(bgemm_wgmma=2), _routes()
    assert ops.launch_counts()["bgemm_wgmma_staged"] == 2


def _shifted(gen, dtype, *shape, std=1.0, by=1):
    """A contiguous view `by` elements past a fresh allocation's start (its
    last element is the allocation's last)."""
    n = int(np.prod(shape))
    return _rand(gen, dtype, n + by, std=std)[by:].view(*shape)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("m,k,n,shift", [(130, 37, 67, 0),      # odd K and N, ragged M
                                         (130, 37, 67, 1),      # the same, every operand off 16 B
                                         (1, 301, 5, 0),        # one row, N below a column pair
                                         (257, 1001, 131, 0),   # many k-steps, ragged all
                                         (128, 64, 128, 1),     # whole tiles, A and B off 16 B
                                         (96, 200, 40, 3),      # K, N multiples of 8, off 16 B
                                         (200, 9, 300, 5)])     # K below one k16 step
def test_staged_wgmma_matches_plain(cuda, epi, m, k, n, shift):
    """Dense bf16 that TMA cannot address in place: gemm, and bgemm over the
    same rows split into a batch of 2 where m is even, each one launch on
    "wgmma" with staged operands, within bf16 TOL of the plain version, two
    launches bitwise equal.  Bias and residual end where their allocations
    end (odd N reads neither past its last column)."""
    from repro_torch.kernels import gemm
    act, bias, gate, res = epi
    a = _shifted(cuda, torch.bfloat16, m, k, by=shift)
    b = _shifted(cuda, torch.bfloat16, k, n, std=k ** -0.5, by=2 * shift)
    kw = dict(activation=act)
    if gate:
        kw["b2"] = _shifted(cuda, torch.bfloat16, k, n, std=k ** -0.5, by=shift)
    if bias:
        kw["bias"] = _shifted(cuda, torch.bfloat16, n, by=shift)
    if res:
        kw["residual"] = _shifted(cuda, torch.bfloat16, m, n, by=shift)
    p = gemm.plan(m, k, n, torch.bfloat16, gate=gate, aligned=gemm.aligned(a, b, kw.get("b2")))
    assert p.route == "wgmma" and p.stage and p.splits == 1
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, b, **kw), torch.bfloat16)
    want = {"gemm_wgmma": 1}
    if m % 2 == 0:
        kw3 = dict(kw, residual=kw["residual"].view(2, m // 2, n)) if res else kw
        _against_plain(lambda: ops.bgemm(a.view(2, m // 2, k), b, **kw3), torch.bfloat16)
        want["bgemm_wgmma"] = 1
    assert _routes(**want), _routes()
    c = ops.launch_counts()
    assert (c["gemm_wgmma_staged"], c["bgemm_wgmma_staged"]) == (1, want.get("bgemm_wgmma", 0))
    first, second = ops.gemm(a, b, **kw), ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,gate", [((128, 128), False), ((128, 64), False),
                                       ((64, 64), False), ((128, 64), True), ((64, 64), True)])
def test_staged_wgmma_every_tile_matches_plain(cuda, tile, gate):
    """Every tile of the plan, without and with the gate, on a ragged (300,
    333) @ (333, 259) + bias gelu [gate] + residual with staged operands."""
    from repro_torch.kernels import gemm
    m, k, n = 300, 333, 259
    a, b, kw = _tc_operands(cuda, 1, m, k, n, ("gelu", True, gate, True))
    a, res = a.view(m, k), kw["residual"].view(m, n)
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    gemm.tc(a, b, out, gemm.Plan("wgmma", tile, stage=True), b2=kw.get("b2"), bias=kw["bias"],
            residual=res, act_code=ops._ACTS["gelu"], m=m, k=k, n=n)
    with ops.reference_mode():
        want = ops.gemm(a, b, **dict(kw, residual=res))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_a_launch_the_staged_wgmma_refuses_raises(cuda):
    """What the tensor-core kernel cannot do with odd shapes comes back as
    an error code, and the wrapper raises: operands it cannot address
    unstaged, K slices over an odd N."""
    from repro_torch.kernels import gemm
    a, b = _rand(cuda, torch.bfloat16, 128, 63), _rand(cuda, torch.bfloat16, 63, 255)
    out = torch.empty(128, 255, dtype=torch.bfloat16, device="cuda")
    kw = dict(bias=None, residual=None, act_code=0, m=128, k=63, n=255)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, b, out, gemm.Plan("wgmma", (128, 64)), b2=None, **kw)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, b, out, gemm.Plan("wgmma", (128, 64), 2, stage=True), b2=None, **kw)
    gemm.tc(a, b, out, gemm.Plan("wgmma", (128, 64), stage=True), b2=None, **kw)
    torch.testing.assert_close(out.float(), (a.float() @ b.float()).bfloat16().float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_a_launch_the_wgmma_kernel_refuses_raises(cuda):
    """Tiles and addresses the kernel does not take come back as an error
    code, and the wrapper raises: the gate's BN stops at 64, there is no
    96-row tile, A must start on a 16-byte boundary."""
    from repro_torch.kernels import gemm
    a, b = _rand(cuda, torch.bfloat16, 128, 64), _rand(cuda, torch.bfloat16, 64, 256)
    out = torch.empty(128, 256, dtype=torch.bfloat16, device="cuda")
    kw = dict(bias=None, residual=None, act_code=0, m=128, k=64, n=256)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, b, out, gemm.Plan("wgmma", (128, 128), 1), b2=b, **kw)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, b, out, gemm.Plan("wgmma", (96, 64), 1), b2=None, **kw)
    shifted = _rand(cuda, torch.bfloat16, 128 * 64 + 1)[1:].view(128, 64)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(shifted, b, out, gemm.Plan("wgmma", (128, 64), 1), b2=None, **kw)
    gemm.tc(a, b, out, gemm.Plan("wgmma", (128, 64), 1), b2=None, **kw)  # the same, aligned
    torch.testing.assert_close(out.float(), (a.float() @ b.float()).bfloat16().float(),
                               **TOL[torch.bfloat16])


# --------------------------------------------------------------------------
# the f64 tensor-core GEMM (csrc/gemm_f64.cu): the "dmma" route of gemm.plan
# --------------------------------------------------------------------------

def _f64_operands(gen, m, k, n, epi):
    act, bias, gate, res = epi
    a, b = _rand(gen, torch.float64, m, k), _rand(gen, torch.float64, k, n, std=k ** -0.5)
    kw = dict(activation=act)
    if gate:
        kw["b2"] = _rand(gen, torch.float64, k, n, std=k ** -0.5)
    if bias:
        kw["bias"] = _rand(gen, torch.float64, n)
    if res:
        kw["residual"] = _rand(gen, torch.float64, m, n)
    return a, b, kw


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("m,k,n", [(130, 36, 66),     # ragged M, N and K (K < one k-step x 3)
                                   (1, 300, 6),       # one row, N below an mma tile
                                   (257, 1000, 130),  # ragged everything, many k-steps
                                   (128, 16, 128),    # one whole tile, one k-step
                                   (300, 2, 2)])      # K = N = 2
def test_dmma_route_matches_plain(cuda, epi, m, k, n):
    """Dense f64 with even K and N: one launch on the "dmma" route, within
    f64 TOL of the plain version, two launches bitwise equal."""
    from repro_torch.kernels import gemm
    a, b, kw = _f64_operands(cuda, m, k, n, epi)
    assert gemm.plan(m, k, n, torch.float64, gate="b2" in kw).route == "dmma"
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, b, **kw), torch.float64)
    assert _routes(), _routes()
    assert ops.launch_counts()["gemm_dmma"] == 1
    first, second = ops.gemm(a, b, **kw), ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,tile,gate,copy", [
    (1, (128, 128), False, 16), (2, (128, 128), False, 16), (3, (128, 128), False, 16),
    (4, (128, 128), False, 16), (5, (128, 128), False, 16), (0, (128, 128), False, 16),
    (0, (64, 64), False, 16), (0, (128, 64), True, 16), (0, (64, 64), True, 16),
    (0, (128, 128), False, 8), (0, (64, 64), False, 8), (0, (128, 64), True, 8),
    (0, (64, 64), True, 8)])
def test_dmma_every_variant_and_tile_matches_plain(cuda, variant, tile, gate, copy):
    """Each kernel of the sweep (1-4: m8n8k4, m16n8k4, m16n8k8, m16n8k16; 5:
    BK = 32 in 3 stages) at 128 x 128, and every tile of the plan (0) in
    both copy widths, on a ragged (200, 100) @ (100, 202) + bias gelu [gate]
    + residual (K = 101, N = 203 with 8-byte copies)."""
    from repro_torch.kernels import gemm
    m, k, n = (200, 100, 202) if copy == 16 else (200, 101, 203)
    a, b, kw = _f64_operands(cuda, m, k, n, ("gelu", True, gate, True))
    out = torch.empty(m, n, dtype=torch.float64, device="cuda")
    gemm.dmma(a, b, out, gemm.Plan("dmma", tile, copy=copy), b2=kw.get("b2"), bias=kw["bias"],
              residual=kw["residual"], act_code=ops._ACTS["gelu"], m=m, k=k, n=n,
              variant=variant)
    with ops.reference_mode():
        want = ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **TOL[torch.float64])


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("m,k,n,shift", [(130, 37, 67, 0),     # odd K and N, ragged M
                                         (1, 301, 5, 0),       # one row, N below an mma tile
                                         (257, 1001, 131, 0),  # ragged everything
                                         (128, 16, 128, 1),    # whole tiles, A and B off 16 B
                                         (300, 2, 2, 1),       # K = N = 2, off 16 B
                                         (130, 37, 67, 1)])    # odd N, every operand off 16 B
def test_dmma_8_byte_copies_match_plain(cuda, epi, m, k, n, shift):
    """Dense f64 that 16-byte copies cannot address: one launch on the
    "dmma" route with 8-byte copies, within f64 TOL of the plain version,
    two launches bitwise equal.  Bias and residual end where their
    allocations end (odd N reads neither past its last column)."""
    from repro_torch.kernels import gemm
    act, bias, gate, res = epi
    a = _shifted(cuda, torch.float64, m, k, by=shift)
    b = _shifted(cuda, torch.float64, k, n, std=k ** -0.5, by=shift)
    kw = dict(activation=act)
    if gate:
        kw["b2"] = _shifted(cuda, torch.float64, k, n, std=k ** -0.5, by=shift)
    if bias:
        kw["bias"] = _shifted(cuda, torch.float64, n, by=shift)
    if res:
        kw["residual"] = _shifted(cuda, torch.float64, m, n, by=shift)
    p = gemm.plan(m, k, n, torch.float64, gate=gate, aligned=gemm.aligned(a, b, kw.get("b2")))
    assert (p.route, p.copy) == ("dmma", 8)
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, b, **kw), torch.float64)
    assert _routes(), _routes()
    assert ops.launch_counts()["gemm_dmma"] == ops.launch_counts()["gemm_dmma_copy8"] == 1
    first, second = ops.gemm(a, b, **kw), ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_odd_or_unaligned_f64_takes_dmma_and_packed_f64_ffma(cuda):
    """Odd K, odd N and an A one element off a 16-byte boundary run the f64
    tensor cores with 8-byte copies; a packed B the f64 tensor cores too
    (csrc/gemm_f64_q8.cu, no longer the CUDA-core kernel); the counts say
    so."""
    a, a37 = _rand(cuda, torch.float64, 9, 64), _rand(cuda, torch.float64, 9, 37)
    b, b37 = _rand(cuda, torch.float64, 64, 64, std=0.125), _rand(cuda, torch.float64, 37, 64)
    b_odd_n = _rand(cuda, torch.float64, 64, 37, std=0.125)
    shifted = _rand(cuda, torch.float64, 9 * 64 + 1)[1:].view(9, 64)
    qb = quant.quantize(_rand(cuda, torch.float32, 64, 64),
                        quant.QuantSpec(16, None, transpose=True))
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a37, b37), torch.float64)
    _against_plain(lambda: ops.gemm(a, b_odd_n), torch.float64)
    _against_plain(lambda: ops.gemm(shifted, b), torch.float64)
    _against_plain(lambda: ops.gemm(a, qb), torch.float64)
    c = ops.launch_counts()
    assert (c["gemm_dmma"], c["gemm_dmma_copy8"], c["gemm_ffma"], c["gemm_int8"]) == (4, 3, 0, 1)


@pytest.mark.cuda
def test_a_launch_the_dmma_kernel_refuses_raises(cuda):
    """Shapes, tiles and addresses the f64 kernel does not take come back as
    an error code, and the wrapper raises: odd K or an A off a 16-byte
    boundary with 16-byte copies, a copy width of 0, the gate at BN = 128, a
    128 x 64 tile without it, a sweep variant off 128 x 128 or with 8-byte
    copies."""
    from repro_torch.kernels import gemm
    a, b = _rand(cuda, torch.float64, 64, 32), _rand(cuda, torch.float64, 32, 64)
    out = torch.empty(64, 64, dtype=torch.float64, device="cuda")
    kw = dict(bias=None, residual=None, act_code=0, m=64, k=32, n=64)
    wide, narrow = gemm.Plan("dmma", (64, 64), copy=16), gemm.Plan("dmma", (64, 64), copy=8)
    with pytest.raises(RuntimeError, match="f64 tensor-core"):
        gemm.dmma(a, b, out, wide, b2=None, **dict(kw, k=31))
    with pytest.raises(RuntimeError, match="f64 tensor-core"):
        gemm.dmma(a, b, out, gemm.Plan("dmma", (64, 64)), b2=None, **kw)
    with pytest.raises(RuntimeError, match="f64 tensor-core"):
        gemm.dmma(a, b, out, gemm.Plan("dmma", (128, 128), copy=16), b2=b, **kw)
    with pytest.raises(RuntimeError, match="f64 tensor-core"):
        gemm.dmma(a, b, out, gemm.Plan("dmma", (128, 64), copy=16), b2=None, **kw)
    with pytest.raises(RuntimeError, match="f64 tensor-core"):
        gemm.dmma(a, b, out, wide, b2=None, variant=1, **kw)
    with pytest.raises(RuntimeError, match="f64 tensor-core"):
        gemm.dmma(a, b, out, gemm.Plan("dmma", (128, 128), copy=8), b2=None, variant=1, **kw)
    shifted = _rand(cuda, torch.float64, 64 * 32 + 1)[1:].view(64, 32)
    with pytest.raises(RuntimeError, match="f64 tensor-core"):
        gemm.dmma(shifted, b, out, wide, b2=None, **kw)
    gemm.dmma(shifted, b, out, narrow, b2=None, **kw)  # 8-byte copies take it
    torch.testing.assert_close(out, shifted @ b, **TOL[torch.float64])
    gemm.dmma(a, b, out, wide, b2=None, **kw)  # the same, aligned
    torch.testing.assert_close(out, a @ b, **TOL[torch.float64])


# --------------------------------------------------------------------------
# f64 A against packed int8 B (csrc/gemm_f64_q8.cu): "dmma" too
# --------------------------------------------------------------------------

# (m, k, n, layout, block, stage): the stored int8 rows (N bytes "kn", K
# bytes "nk") a multiple of 16 bytes and K even (read in place), or not
# (staged into rows padded to 16 bytes: rows of 8, 4 or an odd number of
# bytes, odd K); one scale a 64-row block across N, scales along both
# axes, tiny and awkward blocks, "nk" with one block across K and with
# scales along K; the last two take the 128-row tile without the gate
# (128 x 128; the gate's is 64 x 64)
F64_Q8_CASES = [(130, 96, 144, "kn", (64, None), False), (70, 100, 136, "kn", (50, 17), True),
                (129, 64, 132, "kn", (16, 33), True), (65, 37, 67, "kn", (37, None), True),
                (130, 160, 96, "nk", (32, None), False), (33, 72, 70, "nk", (7, None), True),
                (200, 100, 130, "nk-kblocks", (13, 25), True),
                (9, 37, 20, "nk-kblocks", (4, 3), True), (1, 16, 8, "nk", (8, None), False),
                (257, 130, 200, "kn", (2, 8), True), (1536, 256, 1408, "kn", (64, None), False),
                (1100, 160, 1040, "nk", (16, None), False)]


def _f64_packed(gen, k, n, layout, block):
    """A packed (k, n) B in `layout` whose scales vary block to block."""
    from repro_torch.kernels import gemm
    spec = quant.QuantSpec(block[0], block[1], transpose=layout != "kn")
    ramp = torch.linspace(0.25, 4.0, k * n, device="cuda").view(k, n)
    qb = quant.quantize(_rand(gen, torch.float32, k, n, std=k ** -0.5) * ramp, spec)
    assert gemm.packed_layout(qb) == layout
    return qb


def _deq64(qb):
    """dequantize_in(qb, float64), contiguous (the dense launch's B)."""
    return None if qb is None else quant.dequantize_in(qb, torch.float64).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("epi", [(None, False, False, False), ("gelu", True, False, True),
                                 ("silu", False, True, False), ("relu", True, True, True)])
@pytest.mark.parametrize("m,k,n,layout,block,stage", F64_Q8_CASES)
def test_dmma_packed_is_bitwise_the_dense_launch(cuda, epi, m, k, n, layout, block, stage):
    """f64 A against a packed B, every layout, in place or staged: one launch on
    "dmma" (counted as int8), bitwise the dense launch on
    `dequantize_in(B, float64)` (the same tile and k order: each dequantized
    element is exact), within f64 TOL of the plain version, bitwise a
    second launch."""
    from repro_torch.kernels import gemm
    act, bias, gate, res = epi
    qb, qb2 = (_f64_packed(cuda, k, n, layout, block) for _ in range(2))
    a = _rand(cuda, torch.float64, m, k)
    kw = dict(activation=act, b2=qb2 if gate else None,
              bias=_rand(cuda, torch.float64, n) if bias else None,
              residual=_rand(cuda, torch.float64, m, n) if res else None)
    p = gemm.plan(m, k, n, torch.float64, gate=gate, packed_layout=layout, block=qb.block)
    assert (p.route, p.copy, p.stage) == ("dmma", 16, stage)
    ops.reset_launch_counts()
    got = ops.gemm(a, qb, **kw)
    c = ops.launch_counts()
    assert (c["gemm_int8"], c["gemm_dmma"], c["gemm_ffma"]) == (1, 1, 0)
    dense = ops.gemm(a, _deq64(qb), **dict(kw, b2=_deq64(kw["b2"])))
    with ops.reference_mode():
        want = ops.gemm(a, qb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    torch.testing.assert_close(got, want, **TOL[torch.float64])
    assert torch.equal(ops.gemm(a, qb, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("e,m,k,n,layout,block,shared", [
    (4, 32, 128, 96, "kn", (64, None), False), (3, 33, 100, 72, "nk", (25, None), False),
    (64, 32, 64, 64, "kn", (64, None), False), (2, 65, 96, 67, "kn", (32, 67), True),
    (3, 20, 40, 48, "nk-kblocks", (16, 8), False)])
def test_dmma_packed_batched_is_bitwise_the_dense_launch(cuda, gate, e, m, k, n, layout, block,
                                                         shared):
    """Packed stacks under f64 A with f64 out (a stack a member, or one
    shared): one batched launch on "dmma" counted as packed, bitwise the
    dense batched launch on the dequantized stacks, within f64 TOL of the
    plain version, and each member's bits the same alone."""
    from repro_torch.kernels import gemm
    spec = quant.QuantSpec(block[0], block[1], transpose=layout != "kn")
    lead = () if shared else (e,)
    qb, qb2 = (quant.quantize(_rand(cuda, torch.float32, *lead, k, n, std=k ** -0.5), spec)
               for _ in range(2))
    a, res = _rand(cuda, torch.float64, e, m, k), _rand(cuda, torch.float64, e, m, n)
    kw = dict(b2=qb2 if gate else None, residual=res, activation="silu" if gate else None)
    p = gemm.plan_batched(e, m, k, n, torch.float64, torch.float64, gate=gate,
                          packed_layout=layout, block=qb.block)
    assert p.route == "dmma"
    ops.reset_launch_counts()
    got = ops.bgemm(a, qb, out_dtype=torch.float64, **kw)
    counts = ops.launch_counts()
    assert (counts["bgemm_batched_dmma"], counts["bgemm_batched_int8"]) == (1, 1)
    dense = ops.bgemm(a, _deq64(qb), out_dtype=torch.float64, **dict(kw, b2=_deq64(kw["b2"])))
    with ops.reference_mode():
        want = ops.bgemm(a, qb, out_dtype=torch.float64, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    torch.testing.assert_close(got, want, **TOL[torch.float64])
    z = e - 1

    def member(q):
        if q is None or shared:
            return q
        return quant.QuantizedTensor(q.values[z:z + 1], q.scales[z:z + 1], q.block, q.transposed)

    alone = ops.bgemm(a[z:z + 1], member(qb), out_dtype=torch.float64,
                      **dict(kw, b2=member(kw["b2"]), residual=res[z:z + 1]))
    assert torch.equal(alone[0], got[z])


@pytest.mark.cuda
def test_dmma_packed_stages_operands_off_16_bytes(cuda):
    """int8 values that start one byte past a 16-byte boundary, and an A one
    double past one: the plan stages them, and the launch gives the aligned
    operands' bits, one launch each."""
    from repro_torch.kernels import gemm
    qb = _f64_packed(cuda, 96, 144, "kn", (64, None))
    buf = torch.empty(qb.values.numel() + 1, dtype=torch.int8, device="cuda")
    buf[1:].copy_(qb.values.view(-1))
    off = quant.QuantizedTensor(buf[1:].view(96, 144), qb.scales, qb.block, qb.transposed)
    a = _rand(cuda, torch.float64, 70, 96)
    a_off = _rand(cuda, torch.float64, 70 * 96 + 1)[1:].view(70, 96).copy_(a)
    assert gemm.plan(70, 96, 144, torch.float64, packed_layout="kn", block=qb.block,
                     b_aligned=gemm.aligned(off.values)).stage
    want = ops.gemm(a, qb)
    ops.reset_launch_counts()
    got_b, got_a = ops.gemm(a, off), ops.gemm(a_off, qb)
    torch.cuda.synchronize()
    assert (ops.launch_counts()["gemm_int8"], ops.launch_counts()["gemm_dmma"]) == (2, 2)
    assert torch.equal(got_b, want) and torch.equal(got_a, want)


@pytest.mark.cuda
def test_a_launch_the_f64_int8_kernel_refuses_raises(cuda):
    """What csrc/gemm_f64_q8.cu does not take comes back as an error code and
    the wrapper raises: int8 rows that are not a multiple of 16 bytes, or A
    rows of an odd K, left in place; the gate at BN = 128 or BM = 128, a
    128 x 64 tile without it.  Staged, the same operands run."""
    from repro_torch.kernels import gemm
    qb = _f64_packed(cuda, 64, 72, "kn", (64, None))  # rows of 72 bytes
    q16 = _f64_packed(cuda, 63, 80, "kn", (63, None))  # rows of 80 bytes, odd K
    a, a63 = _rand(cuda, torch.float64, 64, 64), _rand(cuda, torch.float64, 64, 63)
    out = torch.empty(64, 72, dtype=torch.float64, device="cuda")
    kw = dict(bias=None, residual=None, act_code=0, m=64, k=64, n=72)
    for p, b2 in ((gemm.Plan("dmma", (64, 64), copy=16), None),
                  (gemm.Plan("dmma", (128, 128), copy=16, stage=True), qb),
                  (gemm.Plan("dmma", (128, 64), copy=16, stage=True), qb),
                  (gemm.Plan("dmma", (128, 64), copy=16, stage=True), None)):
        with pytest.raises(RuntimeError, match="f64 int8 tensor-core"):
            gemm.dmma(a, qb, out, p, b2=b2, **kw)
    with pytest.raises(RuntimeError, match="f64 int8 tensor-core"):
        gemm.dmma(a63, q16, torch.empty(64, 80, dtype=torch.float64, device="cuda"),
                  gemm.Plan("dmma", (64, 64), copy=16), b2=None, **dict(kw, k=63, n=80))
    gemm.dmma(a, qb, out, gemm.Plan("dmma", (64, 64), copy=16, stage=True), b2=None, **kw)
    torch.testing.assert_close(out, a @ _deq64(qb), **TOL[torch.float64])


# --------------------------------------------------------------------------
# bf16 A against packed "kn" B on the tensor cores (csrc/gemm_sm90.cu)
# --------------------------------------------------------------------------

# (m, k, n, block_m, block_n): one scale a k-step across N (quantize(w)'s
# default), scales every 16 or 32 columns, two k-steps a scale row, ragged
# M, one row
KN_CASES = [(300, 256, 192, 64, None), (257, 384, 160, 128, 32), (130, 192, 80, 64, 16),
            (1, 64, 16, 64, None)]


def _kn_operands(gen, m, k, n, block_m, block_n, epi, shift=0):
    """bf16 a (m, k), starting `shift` elements past its allocation's start,
    packed "kn" B and B2 whose scales vary block to block, ops keywords."""
    act, bias, gate, res = epi
    ramp = torch.linspace(0.25, 4.0, k * n, device="cuda").view(k, n)
    spec = quant.QuantSpec(block_m, block_n)
    qb, qb2 = (quant.quantize(_rand(gen, torch.float32, k, n, std=k ** -0.5) * ramp, spec)
               for _ in range(2))
    a = _shifted(gen, torch.bfloat16, m, k, by=shift)
    kw = dict(activation=act, b2=qb2 if gate else None,
              bias=_rand(gen, torch.bfloat16, n) if bias else None,
              residual=_rand(gen, torch.bfloat16, m, n) if res else None)
    return a, qb, kw


@pytest.mark.cuda
@pytest.mark.parametrize("tile,gate", [((128, 128), False), ((64, 64), False), ((128, 64), True),
                                       ((64, 64), True)])
@pytest.mark.parametrize("m,k,n,block_m,block_n", KN_CASES)
@pytest.mark.parametrize("full", [False, True])
def test_wgmma_int8_kn_every_tile_matches_plain(cuda, tile, gate, m, k, n, block_m, block_n,
                                                full):
    """The 2-D "kn" form at each of its tiles (BM = 128: two consumer and
    two converter warpgroups; BM = 64: the batched form's body), with and without the
    gate, the plain product or bias, gelu and the residual: within bf16 TOL
    of the plain version (which dequantizes B in f32), bitwise a second
    launch."""
    from repro_torch.kernels import gemm
    epi = ("gelu" if full else ("silu" if gate else None), full, gate, full)
    a, qb, kw = _kn_operands(cuda, m, k, n, block_m, block_n, epi)
    b2 = kw["b2"]
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")

    def launch():
        gemm.tc(a, qb.values, out, gemm.Plan("wgmma", tile), b2=None if b2 is None else b2.values,
                bias=kw["bias"], residual=kw["residual"], act_code=ops._ACTS[kw["activation"]],
                m=m, k=k, n=n, scales=qb.scales, scales2=None if b2 is None else b2.scales,
                qa=qb.block[0], qb=qb.block[1])
        return out.clone()

    got = launch()
    with ops.reference_mode():
        want = ops.gemm(a, qb, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    assert torch.equal(launch(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("m,k,n,block_m,block_n,shift", [
    (300, 256, 192, 64, None, 0), (257, 384, 160, 128, 32, 0), (130, 192, 80, 64, 16, 1),
    (2048, 512, 1024, 64, None, 0), (4, 64, 48, 64, 16, 3)])
def test_wgmma_int8_kn_route_matches_plain(cuda, epi, m, k, n, block_m, block_n, shift):
    """bf16 A against packed "kn" B through gemm and bgemm: one launch each
    on "wgmma" (counted as int8; A staged where it starts off 16 bytes,
    never K split), within bf16 TOL of the plain version, bitwise a second
    launch."""
    from repro_torch.kernels import gemm
    a, qb, kw = _kn_operands(cuda, m, k, n, block_m, block_n, epi, shift)
    p = gemm.plan(m, k, n, torch.bfloat16, gate=kw["b2"] is not None, packed_layout="kn",
                  block=qb.block, aligned=gemm.aligned(a))
    assert (p.route, p.splits, p.stage) == ("wgmma", 1, shift != 0)
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, qb, **kw), torch.bfloat16)
    kw3 = dict(kw, residual=None if kw["residual"] is None else kw["residual"][None])
    _against_plain(lambda: ops.bgemm(a[None], qb, **kw3), torch.bfloat16)
    assert _routes(gemm_wgmma=1, bgemm_wgmma=1), _routes()
    assert ops.launch_counts()["gemm_int8"] == 2
    first, second = ops.gemm(a, qb, **kw), ops.gemm(a, qb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_a_2d_kn_launch_the_wgmma_kernel_refuses_raises(cuda):
    """The 2-D "kn" form refuses a K split, a scale block inside a k-step,
    N % 16 != 0, the gate at 128 x 128 and 128 x 64 without the gate (not
    instantiated: 64 x 64 beat it), and the wrapper raises."""
    from repro_torch.kernels import gemm
    a = _rand(cuda, torch.bfloat16, 128, 2048)
    qb = quant.quantize(_rand(cuda, torch.float32, 2048, 64), quant.QuantSpec(64, None))
    out = torch.empty(128, 64, dtype=torch.bfloat16, device="cuda")
    kw = dict(bias=None, residual=None, act_code=0, m=128, k=2048, n=64, scales=qb.scales,
              qa=64, qb=64)
    for p, extra in ((gemm.Plan("wgmma", (64, 64), splits=2), {}),
                     (gemm.Plan("wgmma", (64, 64)), dict(qa=32)),
                     (gemm.Plan("wgmma", (64, 64)), dict(n=56, qb=56)),
                     (gemm.Plan("wgmma", (128, 128)), dict(scales2=qb.scales)),
                     (gemm.Plan("wgmma", (128, 64)), {})):
        b2 = qb.values if "scales2" in extra else None
        with pytest.raises(RuntimeError, match="tensor-core"):
            gemm.tc(a, qb.values, out, p, b2=b2, **dict(kw, **extra))
    gemm.tc(a, qb.values, out, gemm.Plan("wgmma", (64, 64)), b2=None, **kw)
    torch.testing.assert_close(out.float(), a.float() @ quant.dequantize_in(qb, torch.float32),
                               **TOL[torch.bfloat16])


# --------------------------------------------------------------------------
# bgemv (csrc/bgemv.cu): one launch a call, K split by kernels.bgemv.plan
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("k,n", [(2048, 2048), (300, 72), (64, 2050), (2048, 64), (5632, 130)])
def test_bgemv_one_launch_matches_plain(cuda, dtype, batch, k, n):
    """Batches 1-9 (chunks of 4), ragged N and K, split and unsplit plans,
    with and without the gate: within TOL, two launches bitwise equal."""
    from repro_torch.kernels import bgemv
    w, w2 = _rand(cuda, dtype, k, n, std=k ** -0.5), _rand(cuda, dtype, k, n, std=k ** -0.5)
    x, bias, res = _rand(cuda, dtype, batch, k), _rand(cuda, dtype, n), _rand(cuda, dtype, batch, n)
    for kw in (dict(bias=bias), dict(a2=w2, activation="silu", residual=res)):
        ops.reset_launch_counts()
        _against_plain(lambda: ops.bgemv(w, x, **kw, transpose_a=True), dtype)
        assert ops.launch_counts()["bgemv"] == 1
        first = ops.bgemv(w, x, **kw, transpose_a=True)
        second = ops.bgemv(w, x, **kw, transpose_a=True)
        torch.cuda.synchronize()
        assert torch.equal(first, second), bgemv.plan(batch, k, n, dtype, gate="a2" in kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits,rows", [(1, 1024), (2, 512), (7, 160), (32, 32)])
def test_bgemv_every_split_matches_plain(cuda, dtype, splits, rows):
    """Plans other than the chosen one (one split, a short last split, 32
    rows a split) over K = 1000 give the same function."""
    from repro_torch.kernels import bgemv
    k, n, b = 1000, 200, 6
    w, w2 = _rand(cuda, dtype, k, n, std=k ** -0.5), _rand(cuda, dtype, k, n, std=k ** -0.5)
    x, res = _rand(cuda, dtype, b, k), _rand(cuda, dtype, b, n)
    p = bgemv.Plan(128 // (torch.finfo(dtype).bits // 8), splits, rows)
    assert p.k_slices(k)[-1][1] == k
    out = torch.empty(b, n, dtype=dtype, device="cuda")
    bgemv.run(w, x, out, p, w2=w2, bias=None, residual=res, act_code=ops._ACTS["silu"],
              dtype_code=ops._DTYPE_CODES[dtype])
    with ops.reference_mode():
        want = ops.bgemv(w, x, a2=w2, residual=res, activation="silu", transpose_a=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_bgemv_is_one_device_launch_a_call(cuda):
    """The profiler sees one bgemv kernel a call (the split partials are
    combined in the same launch), for split and unsplit plans."""
    from repro_torch.kernels import bgemv
    w, x = _rand(cuda, torch.bfloat16, 2048, 2048, std=2048 ** -0.5), _rand(cuda, torch.bfloat16, 4, 2048)
    w_small, x_small = _rand(cuda, torch.bfloat16, 32, 64), _rand(cuda, torch.bfloat16, 4, 32)
    assert bgemv.plan(4, 2048, 2048, torch.bfloat16).splits > 1
    assert bgemv.plan(4, 32, 64, torch.bfloat16).splits == 1
    ops.bgemv(w, x, transpose_a=True)

    def calls():
        for _ in range(3):
            ops.bgemv(w, x, transpose_a=True)
            ops.bgemv(w_small, x_small, transpose_a=True)

    names = _profiled_kernels(calls, "bgemv_kernel", 6)
    assert sum("bgemv_kernel" in name for name in names) == 6
    assert not [name for name in names if "bgemv" in name and "bgemv_kernel" not in name]


@pytest.mark.cuda
def test_a_launch_the_bgemv_kernel_refuses_raises(cuda):
    """A plan that does not cover K, a slice that is not whole 32-row steps
    or longer than 1024 rows, an empty last slice: an error code, and the
    wrapper raises."""
    from repro_torch.kernels import bgemv
    w, x = _rand(cuda, torch.float32, 256, 64), _rand(cuda, torch.float32, 2, 256)
    out = torch.empty(2, 64, device="cuda")
    kw = dict(w2=None, bias=None, residual=None, act_code=0, dtype_code=0)
    for p in (bgemv.Plan(32, 2, 64), bgemv.Plan(32, 2, 130), bgemv.Plan(32, 1, 2048),
              bgemv.Plan(32, 9, 32)):
        with pytest.raises(RuntimeError, match="bgemv kernel"):
            bgemv.run(w, x, out, p, **kw)
    bgemv.run(w, x, out, bgemv.Plan(32, 2, 128), **kw)
    torch.testing.assert_close(out, x @ w, **TOL[torch.float32])


# --------------------------------------------------------------------------
# bgemv's other forms: op = A (csrc/bgemv_rows.cu) and a per-member A (both
# bodies), in f32, bf16 and f64; kernels.bgemv.plan names the form
# --------------------------------------------------------------------------

BGEMV_FORMS = [(False, False), (False, True), (True, False), (True, True)]  # (trans, batched)
BGEMV_EPILOGUES = [dict(), dict(a2=True, activation="silu"),
                   dict(bias=True, activation="gelu", residual=True)]


def _bgemv_operands(gen, dtype, batch, m, n, trans, batched, epi, shift=0):
    """A ((batch,) m, n), or ((batch,) n, m) under trans, x (batch, n) and
    the epilogue's operands, bias and residual at the end of their
    allocations (a kernel reading past m shows); A and A2 `shift` elements
    into theirs (off 16 bytes where shift is not a multiple of 16 bytes)."""
    shape = ((batch,) if batched else ()) + ((n, m) if trans else (m, n))

    def operand():
        if not shift:
            return _rand(gen, dtype, *shape, std=max(n, 1) ** -0.5)
        flat = _rand(gen, dtype, int(np.prod(shape)) + shift, std=max(n, 1) ** -0.5)
        return flat[shift:].view(shape)

    a = operand()
    kw = dict(activation=epi.get("activation"), transpose_a=trans)
    if epi.get("a2"):
        kw["a2"] = operand()
    if epi.get("bias"):
        kw["bias"] = _rand(gen, dtype, m + 1)[1:]
    if epi.get("residual"):
        kw["residual"] = _rand(gen, dtype, batch * m + 1)[1:].view(batch, m)
    return a, _rand(gen, dtype, batch, n), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("trans,batched", BGEMV_FORMS)
@pytest.mark.parametrize("batch,m,n", [(3, 257, 131), (2, 13, 89), (3, 101, 640), (1, 1, 1),
                                       (2, 129, 7), (9, 64, 2048)])
def test_bgemv_forms_match_plain(cuda, dtype, trans, batched, batch, m, n):
    """Every form at the reference's conformance and prime shapes (ragged m
    and n, rows off 16 bytes, batches past a chunk of 4), under each
    epilogue: within TOL, one launch counted on its form, two launches
    bitwise equal."""
    from repro_torch.kernels import bgemv
    form = ("batched_" if batched else "broadcast_") + ("t" if trans else "n")
    for epi in BGEMV_EPILOGUES:
        a, x, kw = _bgemv_operands(cuda, dtype, batch, m, n, trans, batched, epi)
        ops.reset_launch_counts()
        _against_plain(lambda: ops.bgemv(a, x, **kw), dtype)
        counts = ops.launch_counts()
        assert counts["bgemv"] == counts[f"bgemv_{form}"] == 1, counts
        assert bgemv.plan_for(a, x, "a2" in kw, trans).form == form
        first, second = ops.bgemv(a, x, **kw), ops.bgemv(a, x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("splits,rows", [(1, 1024), (2, 512), (7, 160), (32, 32), (125, 8)])
def test_bgemv_batched_every_split_matches_plain(cuda, dtype, splits, rows):
    """The per-member column body (512-byte tiles, 8-row steps) under plans
    other than the chosen one (one split, a short last split, 32 rows and
    one 8-row step a split) over K = 1000, with the gate and the residual:
    the same function, bitwise twice."""
    from repro_torch.kernels import bgemv
    k, n, b = 1000, 200, 5
    w, w2 = (_rand(cuda, dtype, b, k, n, std=k ** -0.5) for _ in range(2))
    x, res = _rand(cuda, dtype, b, k), _rand(cuda, dtype, b, n)
    p = bgemv.Plan(512 // (torch.finfo(dtype).bits // 8), splits, rows, batched=True)
    assert p.k_slices(k)[-1][1] == k

    def call():
        out = torch.empty(b, n, dtype=dtype, device="cuda")
        return bgemv.run(w, x, out, p, w2=w2, bias=None, residual=res,
                         act_code=ops._ACTS["silu"], dtype_code=ops._DTYPE_CODES[dtype])

    got, again = call(), call()
    with ops.reference_mode():
        want = ops.bgemv(w, x, a2=w2, residual=res, activation="silu", transpose_a=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), want.double(), **TOL[dtype])
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("wpr,block", [(1, False), (1, True), (2, False), (4, False), (8, False)])
def test_bgemv_rows_every_split_matches_plain(cuda, dtype, batched, gate, wpr, block):
    """The op = A body with 1-8 warps a row (its K split) or a block of rows
    a warp (ROW_BLOCK, half as many under the gate), a ragged row count and
    row length and 5 batch rows: the same function as the plain version; a
    block of rows with 2 warps a row is refused."""
    from repro_torch.kernels import bgemv
    b, m, n = 5, 37, 3001
    epi = dict(bias=True, residual=True, activation="relu", a2=gate)
    a, x, kw = _bgemv_operands(cuda, dtype, b, m, n, False, batched, epi)
    rows = bgemv.ROW_BLOCK // (2 if gate else 1) if block else 1
    out = torch.empty(b, m, dtype=dtype, device="cuda")
    run = dict(w2=kw.get("a2"), bias=kw["bias"], residual=kw["residual"],
               act_code=ops._ACTS["relu"], dtype_code=ops._DTYPE_CODES[dtype])
    bgemv.run(a, x, out, bgemv.Plan(0, 1, rows, batched, False, wpr), **run)
    with ops.reference_mode():
        want = ops.bgemv(a, x, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.double(), want.double(), **TOL[dtype])
    for bad in (bgemv.Plan(0, 1, 4, batched, False, 2), bgemv.Plan(0, 1, 3, batched, False, 1)):
        with pytest.raises(RuntimeError, match="bgemv kernel launch failed"):
            bgemv.run(a, x, out, bad, **run)


# the short-member body (csrc/bgemv_members.cu): a per-member A of at most
# bgemv.MEMBER_MAX_BYTES, both ops, one warp a member
BGEMV_SHORT_EPILOGUES = {"plain": dict(), "bias_gelu_res": dict(bias=True, activation="gelu",
                                                                 residual=True),
                         "silu_gate": dict(a2=True, activation="silu")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("epi", list(BGEMV_SHORT_EPILOGUES))
@pytest.mark.parametrize("batch,m,n,shift", [(4096, 32, 32, 0), (257, 7, 129, 0),
                                             (1000, 37, 19, 1), (2, 1, 1, 0)])
def test_bgemv_short_members_match_plain(cuda, dtype, trans, epi, batch, m, n, shift):
    """Short members (whole 16-byte rows; ragged rows longer than a warp's
    32 chunks; ragged rows of elements with A off 16 bytes; one element)
    under each epilogue: one launch, counted on its form and as a
    short-member launch; within TOL of the plain version; bitwise on a
    second launch; and each of a few members bitwise the same alone (a
    batch of 1) as in the full batch."""
    from repro_torch.kernels import bgemv
    a, x, kw = _bgemv_operands(cuda, dtype, batch, m, n, trans, True, BGEMV_SHORT_EPILOGUES[epi],
                               shift=shift)
    assert bgemv.plan_for(a, x, "a2" in kw, trans).members == bgemv.MEMBERS
    ops.reset_launch_counts()
    _against_plain(lambda: ops.bgemv(a, x, **kw), dtype)
    counts = ops.launch_counts()
    form = "batched_t" if trans else "batched_n"
    assert counts["bgemv"] == counts[f"bgemv_{form}"] == counts["bgemv_members"] == 1, counts
    first, second = ops.bgemv(a, x, **kw), ops.bgemv(a, x, **kw)
    for i in sorted({0, batch // 2, batch - 1}):
        alone = dict(kw, a2=kw["a2"][i:i + 1]) if "a2" in kw else dict(kw)
        if "residual" in kw:
            alone["residual"] = kw["residual"][i:i + 1]
        one = ops.bgemv(a[i:i + 1], x[i:i + 1], **alone)
        torch.cuda.synchronize()
        assert torch.equal(one[0], first[i]), i
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_bgemv_members_launch_refuses_a_plan_it_was_not_built_for(cuda):
    """Members a block not a multiple of the block's 8 warps, above 256, or
    a short-member plan over a broadcast (2-D) A: an error code, and the
    wrapper raises; the plan's own members run."""
    from repro_torch.kernels import bgemv
    a, x, kw = _bgemv_operands(cuda, torch.float32, 20, 32, 32, True, True, {})
    out = torch.empty(20, 32, device="cuda")
    run = dict(w2=None, bias=None, residual=None, act_code=0, dtype_code=0)
    for members, w in ((12, a), (4, a), (264, a), (8, a[0])):
        with pytest.raises(RuntimeError, match="bgemv kernel launch failed"):
            bgemv.run(w, x, out, bgemv.Plan(0, 1, 0, True, True, members=members), **run)
    bgemv.run(a, x, out, bgemv.Plan(0, 1, 0, True, True, members=16), **run)
    with ops.reference_mode():
        want = ops.bgemv(a, x, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **TOL[torch.float32])


@pytest.mark.cuda
def test_bgemv_forms_are_one_device_launch_a_call(cuda):
    """The profiler sees one kernel a call in every form: bgemv_kernel for
    op = A^T, bgemv_rows_kernel for op = A, a split per-member plan
    included (its partials combined in the same launch)."""
    from repro_torch.kernels import bgemv
    calls = []
    for trans, batched in BGEMV_FORMS:
        a, x, kw = _bgemv_operands(cuda, torch.float64, 8, 512, 2048, trans, batched, {})
        calls.append(lambda a=a, x=x, kw=kw: ops.bgemv(a, x, **kw))
    assert bgemv.plan(8, 2048, 512, torch.float64, batched=True).splits > 1
    for call in calls:
        call()

    def run():
        for call in calls:
            call()

    names = _profiled_kernels(run, "bgemv", 4)
    assert sum("bgemv_kernel" in name for name in names) == 2, names
    assert sum("bgemv_rows_kernel" in name for name in names) == 2, names
    assert len(names) == 4, names


# --------------------------------------------------------------------------
# flash attention's flat (BH, T, D) layout, kv_lens optional
# --------------------------------------------------------------------------

def _flat_case(gen, dtype, bh, g, tq, s, d, int8=False, lens=None):
    """q (BH, Tq, D), K/V (BH // g, S, D) (int8: values and f32 scales),
    NaN past every row's kv length, and kv_lens (BH,) int32 or None."""
    q = _rand(gen, dtype, bh, tq, d)
    kw = {}
    for name in "kv":
        x = _rand(gen, torch.float32, bh // g, s, d)
        if lens is not None:
            for r in range(bh // g):
                x[r, max(lens[r * g:(r + 1) * g]):] = float("nan")
        if int8:
            qt = quant.quantize_kv(torch.nan_to_num(x))
            kw[name], kw[f"{name}_scales"] = qt.values, qt.scales
            if lens is not None:
                for r in range(bh // g):
                    kw[f"{name}_scales"][r, max(lens[r * g:(r + 1) * g]):] = float("nan")
        else:
            kw[name] = x.to(dtype)
    kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kw, kv_lens


FLAT_CASES = [  # (bh, g, tq, s, d, lens: None or each row's)
    (8, 1, 1, 300, 64, None), (8, 4, 1, 300, 64, [5, 37, 64, 160, 1, 97, 300, 299]),
    (6, 1, 100, 100, 64, None), (6, 3, 64, 128, 32, None),
    (4, 2, 60, 200, 128, [60, 200, 150, 61]), (4, 4, 33, 33, 256, None), (3, 1, 17, 40, 16, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mask", [dict(), dict(prefix_len=13), dict(causal=False)])
@pytest.mark.parametrize("bh,g,tq,s,d,lens", FLAT_CASES)
def test_flash_attention_flat_matches_plain(cuda, dtype, int8, mask, bh, g, tq, s, d, lens):
    """Flat operands on every route (decode "splitkv", bf16 "mma", f32
    "ffma"), MHA and GQA, dense and int8 K/V, each mask, with and without
    kv_lens: within TOL, one launch counted under its route and the flat
    layout, bitwise a second launch; the flat call gives the bits of the
    cache-layout call on the same data where g = 1."""
    from repro_torch.kernels import attention
    q, kw, kv_lens = _flat_case(cuda, dtype, bh, g, tq, s, d, int8, lens)
    call = lambda: ops.flash_attention(q, kv_lens=kv_lens, kv_groups=g, **kw, **mask)  # noqa: E731
    ops.reset_launch_counts()
    _against_plain(call, dtype)
    route = attention.plan(bh // g, tq, g, 1, d, s, dtype, int8).route
    assert ops.attention_layouts()[f"{route}/flat"] == 1
    assert sum(ops.attention_layouts().values()) == 1
    first, second = call(), call()
    torch.cuda.synchronize()
    assert first.shape == q.shape and torch.equal(first, second)
    if g == 1:  # the cache layout with B = BH, H = 1: the same bits
        cache = ops.flash_attention(q[:, :, None], kv_lens=kv_lens,
                                    **{k: t[:, :, None] for k, t in kw.items()}, **mask)
        torch.cuda.synchronize()
        assert torch.equal(cache[:, :, 0], first)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,dtype", [(1, torch.bfloat16), (128, torch.bfloat16),
                                      (128, torch.float32)])
def test_flash_attention_flat_launches_no_copy(cuda, tq, dtype):
    """A flat GQA call with kv_lens None is one device launch, the route's
    attention kernel, and nothing else: no copy of q, k or v, no fill of
    the lengths (a persistent buffer, filled at the first such call)."""
    q, kw, _ = _flat_case(cuda, dtype, 64, 4, tq, 1024, 64)
    ops.flash_attention(q, kv_groups=4, **kw)

    def call():
        ops.flash_attention(q, kv_groups=4, **kw)

    names = _profiled_kernels(call, "attention", 1)
    assert len(names) == 1 and "attention" in names[0], names


@pytest.mark.cuda
def test_flash_attention_flat_refuses_a_page_table(cuda):
    q, kw, _ = _flat_case(cuda, torch.bfloat16, 4, 1, 1, 16, 64)
    table = torch.zeros(4, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="page_table requires"):
        ops.flash_attention(q, page_table=table, **kw)


# --------------------------------------------------------------------------
# the f32 GEMM on a TMA ring (csrc/gemm_f32.cu): the "ffma_sm90" route
# --------------------------------------------------------------------------

def _f32_operands(gen, m, k, n, epi, batch=None):
    act, bias, gate, res = epi
    a = _rand(gen, torch.float32, *((batch,) if batch else ()), m, k)
    b = _rand(gen, torch.float32, k, n, std=k ** -0.5)
    kw = dict(activation=act)
    if gate:
        kw["b2"] = _rand(gen, torch.float32, k, n, std=k ** -0.5)
    if bias:
        kw["bias"] = _rand(gen, torch.float32, n)
    if res:
        kw["residual"] = _rand(gen, torch.float32, *((batch,) if batch else ()), m, n)
    return a, b, kw


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("m,k,n", [(128, 64, 256),     # whole 128 x 128 tiles, two k-steps
                                   (132, 128, 68),     # ragged M and N
                                   (2048, 128, 2048),  # zamba2's LoRA merge
                                   (70, 12, 36),       # K below one k-step (32)
                                   (1, 100, 4)])       # one row, ragged K, N = 4
def test_ffma_sm90_route_matches_plain(cuda, epi, m, k, n):
    """Dense f32 with K and N multiples of 4: gemm, and bgemm over the same
    rows split into a batch of 2 where m is even, each one launch on the
    "ffma_sm90" route, within f32 TOL of the plain version, two launches
    bitwise equal."""
    from repro_torch.kernels import gemm
    a, b, kw = _f32_operands(cuda, m, k, n, epi)
    assert gemm.plan(m, k, n, torch.float32, gate="b2" in kw).route == "ffma_sm90"
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, b, **kw), torch.float32)
    want = {"gemm_ffma_sm90": 1}
    if m % 2 == 0:
        kw3 = dict(kw, residual=kw["residual"].view(2, m // 2, n)) if "residual" in kw else kw
        _against_plain(lambda: ops.bgemm(a.view(2, m // 2, k), b, **kw3), torch.float32)
        want["bgemm_ffma_sm90"] = 1
    assert _routes(**want), _routes()
    first, second = ops.gemm(a, b, **kw), ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,gate", [((128, 128), False), ((128, 64), False),
                                       ((64, 64), False), ((128, 64), True), ((64, 64), True)])
def test_ffma_sm90_every_tile_matches_plain(cuda, tile, gate):
    """Every tile of the plan, without and with the gate, on a ragged (1100,
    100) @ (100, 2052) + bias gelu [gate] + residual."""
    from repro_torch.kernels import gemm
    m, k, n = 1100, 100, 2052
    a, b, kw = _f32_operands(cuda, m, k, n, ("gelu", True, gate, True))
    out = torch.empty(m, n, device="cuda")
    gemm.ffma_sm90(a, b, out, gemm.Plan("ffma_sm90", tile), b2=kw.get("b2"), bias=kw["bias"],
                   residual=kw["residual"], act_code=ops._ACTS["gelu"], m=m, k=k, n=n)
    with ops.reference_mode():
        want = ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **TOL[torch.float32])


@pytest.mark.cuda
def test_odd_unaligned_or_packed_f32_takes_the_ffma_route(cuda):
    """What of f32 the ring does not take: a packed B whose stored int8 rows
    TMA cannot address ("kn" with N % 16 != 0, "nk" with K % 16 != 0), a
    packed B under an A one element off a 16-byte boundary, and K = 0 (the
    epilogue alone): the first CUDA-core kernel, and the counts say so."""
    a, a37 = _rand(cuda, torch.float32, 9, 64), _rand(cuda, torch.float32, 9, 37)
    shifted = _rand(cuda, torch.float32, 9 * 64 + 1)[1:].view(9, 64)
    spec = quant.QuantSpec(16, None)
    q_n66 = quant.quantize(_rand(cuda, torch.float32, 64, 66), spec)
    q_k37 = quant.quantize(_rand(cuda, torch.float32, 37, 64), quant.QuantSpec(16, None, transpose=True))
    qb = quant.quantize(_rand(cuda, torch.float32, 64, 64), spec)
    a0, b0 = _rand(cuda, torch.float32, 9, 0), _rand(cuda, torch.float32, 0, 64)
    bias = _rand(cuda, torch.float32, 64)
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, q_n66), torch.float32)
    _against_plain(lambda: ops.gemm(a37, q_k37), torch.float32)
    _against_plain(lambda: ops.gemm(shifted, qb), torch.float32)
    _against_plain(lambda: ops.gemm(a0, b0, bias=bias, activation="gelu"), torch.float32)
    assert _routes(gemm_ffma=4), _routes()
    assert ops.launch_counts()["gemm_int8"] == 3


# the f32 ring on staged operands (csrc/gemm_f32.cu):
# (m, k, n, elements A starts past a 16-byte boundary): odd K and N, K and N
# even but not multiples of 4, A off 16 bytes by 8 and by 4 bytes, one row,
# K of 1, a ragged fringe over several k-steps, N % 4 only
F32_STAGED_CASES = [(70, 37, 53, 0), (132, 66, 70, 0), (64, 64, 64, 2), (64, 64, 64, 1),
                    (1, 3, 5, 0), (300, 1, 7, 0), (130, 100, 131, 0), (257, 256, 130, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("epi", TC_EPILOGUES)
@pytest.mark.parametrize("m,k,n,shift", F32_STAGED_CASES)
def test_ffma_sm90_staged_matches_plain(cuda, epi, m, k, n, shift):
    """Dense f32 TMA cannot address in place: one launch on "ffma_sm90" on
    staged operands (`Plan.stage`; C one element a store where N % 4 !=
    0), counted as such, within f32 TOL of the plain version, two
    launches bitwise equal; bgemm over the same rows as a batch of 2 where
    m is even."""
    from repro_torch.kernels import gemm
    a, b, kw = _f32_operands(cuda, m, k, n, epi)
    if shift:
        a = _rand(cuda, torch.float32, m * k + shift)[shift:].view(m, k).copy_(a)
    p = gemm.plan(m, k, n, torch.float32, gate="b2" in kw,
                  aligned=gemm.aligned(a, b, kw.get("b2")))
    assert (p.route, p.stage, p.copy) == ("ffma_sm90", True, 0)
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, b, **kw), torch.float32)
    want = {"gemm_ffma_sm90": 1}
    if m % 2 == 0 and not shift:
        kw3 = dict(kw, residual=kw["residual"].view(2, m // 2, n)) if "residual" in kw else kw
        _against_plain(lambda: ops.bgemm(a.view(2, m // 2, k), b, **kw3), torch.float32)
        want["bgemm_ffma_sm90"] = 1
    assert _routes(**want), _routes()
    c = ops.launch_counts()
    assert (c["gemm_ffma_sm90_staged"], c["bgemm_ffma_sm90_staged"]) == (1, len(want) - 1)
    assert (c["gemm_ffma_sm90_odd"], c["bgemm_ffma_sm90_odd"]) == (
        n % 4 != 0, (n % 4 != 0) * (len(want) - 1))
    first, second = ops.gemm(a, b, **kw), ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,gate", [((128, 128), False), ((128, 64), False),
                                       ((64, 64), False), ((128, 64), True), ((64, 64), True)])
@pytest.mark.parametrize("n,c_off", [(514, 0), (516, 1)])
def test_ffma_sm90_odd_every_tile_matches_plain(cuda, tile, gate, n, c_off):
    """Every 2-D tile's element stores (C's width picked at run time),
    without and with the gate, on a ragged (300, 130) @ (130, n) + bias gelu [gate]
    + residual on staged operands: N % 4 != 0, and N % 4 == 0 with C one
    element off a 16-byte boundary."""
    from repro_torch.kernels import gemm
    m, k = 300, 130
    a, b, kw = _f32_operands(cuda, m, k, n, ("gelu", True, gate, True))
    out = _rand(cuda, torch.float32, m * n + c_off)[c_off:].view(m, n)
    gemm.ffma_sm90(a, b, out, gemm.Plan("ffma_sm90", tile, stage=True),
                   b2=kw.get("b2"), bias=kw["bias"], residual=kw["residual"],
                   act_code=ops._ACTS["gelu"], m=m, k=k, n=n)
    with ops.reference_mode():
        want = ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("batch,m,k,n", [(4, 32, 37, 66), (3, 33, 130, 98), (64, 32, 71, 40)])
def test_ffma_sm90_staged_batched_member_bits(cuda, shared, batch, m, k, n):
    """The batched launch on staged operands (f32 out, K or N not a
    multiple of 4), a B a member or one shared: within f32 TOL of the plain
    version, and each member's bits the same as in a launch of that member
    alone."""
    from repro_torch.kernels import gemm
    a, b, kw = _batched_case(cuda, torch.float32, batch, m, k, n, "silu", True, True, True,
                             shared=shared)
    p = gemm.plan_batched(batch, m, k, n, torch.float32, torch.float32, gate=True)
    assert (p.route, p.stage) == ("ffma_sm90", True)
    ops.reset_launch_counts()
    got = ops.bgemm(a, b, out_dtype=torch.float32, **kw)
    c = ops.launch_counts()
    assert (c["bgemm_batched_ffma_sm90"], c["bgemm_batched_staged"]) == (1, 1)
    with ops.reference_mode():
        want = ops.bgemm(a, b, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    for z in (0, batch - 1):
        one = {key: (v if v.ndim == 1 or (shared and key == "b2") else v[z:z + 1])
               for key, v in kw.items() if torch.is_tensor(v)}
        alone = ops.bgemm(a[z:z + 1], b if shared else b[z:z + 1], out_dtype=torch.float32,
                          activation="silu", **one)
        assert torch.equal(alone[0], got[z])


# (m, k, n, block_m, block_n, layout): the serving specs ("nk" one scale
# block across K, "kn" one a 64-row k-step across N), scales along K
# ("nk-kblocks"), blocks that end inside a unit of 4 (block_n 2 / 6, block_m
# 6), a ragged K (one k-step and a half), odd M and N ("nk")
F32_Q8_CASES = [(130, 128, 96, 64, None, "nk"), (70, 96, 64, 64, None, "kn"),
                (33, 128, 80, 32, 32, "nk-kblocks"), (9, 48, 96, 6, 2, "kn"),
                (40, 64, 67, 6, 2, "nk-kblocks"), (1, 16, 16, 16, None, "nk"),
                (300, 160, 144, 40, 48, "kn")]


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("m,k,n,block_m,block_n,layout", F32_Q8_CASES)
def test_ffma_sm90_packed_matches_plain(cuda, gate, m, k, n, block_m, block_n, layout):
    """f32 A against a packed B whose int8 rows TMA can address: one launch
    on "ffma_sm90" (gemm, and bgemm over the same rows), each element
    dequantized as `reference_int8` does, within f32 TOL of it, with bias,
    the activation and the residual, two launches bitwise equal."""
    from repro_torch.kernels import gemm
    spec = quant.QuantSpec(block_m, block_n, transpose=layout != "kn")
    ramp = torch.linspace(0.25, 4.0, k * n, device="cuda").view(k, n)
    qb, qb2 = (quant.quantize(_rand(cuda, torch.float32, k, n, std=k ** -0.5) * ramp, spec)
               for _ in range(2))
    assert gemm.packed_layout(qb) == layout
    a, bias, res = (_rand(cuda, torch.float32, m, k), _rand(cuda, torch.float32, n),
                    _rand(cuda, torch.float32, m, n))
    kw = dict(b2=qb2 if gate else None, bias=bias, residual=res,
              activation="silu" if gate else "gelu")
    assert gemm.plan(m, k, n, torch.float32, gate=gate, packed_layout=layout).route == "ffma_sm90"
    ops.reset_launch_counts()
    _against_plain(lambda: ops.gemm(a, qb), torch.float32)
    _against_plain(lambda: ops.gemm(a, qb, **kw), torch.float32)
    _against_plain(lambda: ops.bgemm(a[None], qb, **dict(kw, residual=res[None])),
                   torch.float32)
    assert _routes(gemm_ffma_sm90=2, bgemm_ffma_sm90=1), _routes()
    assert ops.launch_counts()["gemm_int8"] == 3
    first, second = ops.gemm(a, qb, **kw), ops.gemm(a, qb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("e,m,k,n,shared", [(4, 32, 128, 96, False), (3, 33, 96, 160, False),
                                            (64, 32, 64, 64, False), (2, 65, 160, 48, True)])
def test_ffma_sm90_packed_batched_matches_plain(cuda, layout, gate, e, m, k, n, shared):
    """Packed stacks (a stack a member, or one shared) under f32 A with f32
    out: one batched launch on "ffma_sm90", counted as packed, within f32
    TOL of the plain version, bitwise a second launch, and each member's
    bits the same alone."""
    from repro_torch.kernels import gemm
    spec = quant.QuantSpec(64 if layout == "kn" else 32, None, transpose=layout == "nk")
    lead = () if shared else (e,)
    qb, qb2 = (quant.quantize(_rand(cuda, torch.float32, *lead, k, n, std=k ** -0.5), spec)
               for _ in range(2))
    a, res = _rand(cuda, torch.float32, e, m, k), _rand(cuda, torch.float32, e, m, n)
    kw = dict(b2=qb2 if gate else None, residual=res, activation="silu" if gate else None)
    p = gemm.plan_batched(e, m, k, n, torch.float32, torch.float32, gate=gate,
                          packed_layout=layout, block=qb.block)
    assert (p.route, p.copy) == ("ffma_sm90", 0)
    ops.reset_launch_counts()
    got = ops.bgemm(a, qb, out_dtype=torch.float32, **kw)
    counts = ops.launch_counts()
    assert (counts["bgemm_batched_ffma_sm90"], counts["bgemm_batched_int8"]) == (1, 1)
    with ops.reference_mode():
        want = ops.bgemm(a, qb, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert torch.equal(ops.bgemm(a, qb, out_dtype=torch.float32, **kw), got)
    z = e - 1

    def member(q):
        if q is None or shared:
            return q
        return quant.QuantizedTensor(q.values[z:z + 1], q.scales[z:z + 1], q.block, q.transposed)

    alone = ops.bgemm(a[z:z + 1], member(qb), out_dtype=torch.float32,
                      **dict(kw, b2=member(kw["b2"]), residual=res[z:z + 1]))
    assert torch.equal(alone[0], got[z])


@pytest.mark.cuda
def test_a_launch_the_ffma_sm90_kernel_refuses_raises(cuda):
    """Shapes, tiles and addresses the f32 ring kernel does not take come
    back as an error code, and the wrapper raises: K % 4, the gate at BN =
    128, a 64 x 128 tile (none such), an A off a 16-byte boundary."""
    from repro_torch.kernels import gemm
    a, b = _rand(cuda, torch.float32, 64, 32), _rand(cuda, torch.float32, 32, 64)
    out = torch.empty(64, 64, device="cuda")
    kw = dict(bias=None, residual=None, act_code=0, m=64, k=32, n=64)
    for plan, extra in ((gemm.Plan("ffma_sm90", (64, 64)), dict(b2=None, k=30)),
                        (gemm.Plan("ffma_sm90", (128, 128)), dict(b2=b)),
                        (gemm.Plan("ffma_sm90", (64, 128)), dict(b2=None))):
        with pytest.raises(RuntimeError, match="f32 TMA-ring"):
            gemm.ffma_sm90(a, b, out, plan, **dict(kw, **extra))
    shifted = _rand(cuda, torch.float32, 64 * 32 + 1)[1:].view(64, 32)
    with pytest.raises(RuntimeError, match="f32 TMA-ring"):
        gemm.ffma_sm90(shifted, b, out, gemm.Plan("ffma_sm90", (64, 64)), b2=None, **kw)
    gemm.ffma_sm90(a, b, out, gemm.Plan("ffma_sm90", (64, 64)), b2=None, **kw)  # aligned
    torch.testing.assert_close(out, a @ b, **TOL[torch.float32])


@pytest.mark.cuda
def test_a_launch_the_f32_feed_kernels_refuse_raises(cuda):
    """What the staged and int8 forms of the ring do not take comes back as
    an error code, and the wrapper raises: an ODD launch at a tile none is
    built for (64 x 128, the gate at 128 x 128), "kn" int8 rows of 40 bytes,
    a tile the int8 kernel is not built for, an A off 16 bytes under a
    packed B."""
    from repro_torch.kernels import gemm
    a, b = _rand(cuda, torch.float32, 64, 34), _rand(cuda, torch.float32, 34, 66)
    out = torch.empty(64, 66, device="cuda")
    kw = dict(bias=None, residual=None, act_code=0, m=64, k=34, n=66)
    for plan, extra in ((gemm.Plan("ffma_sm90", (64, 128), stage=True), dict(b2=None)),
                        (gemm.Plan("ffma_sm90", (128, 128), stage=True), dict(b2=b))):
        with pytest.raises(RuntimeError, match="f32 TMA-ring"):
            gemm.ffma_sm90(a, b, out, plan, **dict(kw, **extra))
    gemm.ffma_sm90(a, b, out, gemm.Plan("ffma_sm90", (64, 64), stage=True), b2=None,
                   **kw)
    torch.testing.assert_close(out, a @ b, **TOL[torch.float32])
    a32, out64 = _rand(cuda, torch.float32, 64, 32), torch.empty(64, 64, device="cuda")
    q40 = quant.quantize(_rand(cuda, torch.float32, 32, 40), quant.QuantSpec(16, None))
    q64 = quant.quantize(_rand(cuda, torch.float32, 32, 64), quant.QuantSpec(16, None))
    packed = dict(kw, k=32, n=64, b2=None)
    with pytest.raises(RuntimeError, match="int8 ring"):
        gemm.ffma_sm90(a32, q40, torch.empty(64, 40, device="cuda"),
                       gemm.Plan("ffma_sm90", (64, 64)), **dict(packed, n=40))
    with pytest.raises(RuntimeError, match="int8 ring"):
        gemm.ffma_sm90(a32, q64, out64, gemm.Plan("ffma_sm90", (64, 128)), **packed)
    a_off = _rand(cuda, torch.float32, 64 * 32 + 1)[1:].view(64, 32)
    with pytest.raises(RuntimeError, match="int8 ring"):
        gemm.ffma_sm90(a_off, q64, out64, gemm.Plan("ffma_sm90", (64, 64)), **packed)


# --------------------------------------------------------------------------
# axpy (csrc/blas1.cu): bitwise the plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("n,offset", [(2 ** 20, 0), (2 ** 20 - 3, 0), (100003, 1),
                                      (2 ** 20, 1), (5, 0), (0, 0)])
def test_axpy_is_bitwise_the_plain_version(cuda, dtype, n, offset):
    """alpha * x + y rounds the product and the sum once each in the
    accumulator type, as the plain version does: the same bits, on aligned
    vectors (one block a chunk of 16-byte vectors, and the tail), ragged
    ones and views one element in (element loads over the grid-stride
    grid), one launch each."""
    buf_x, buf_y = _rand(cuda, dtype, n + offset), _rand(cuda, dtype, n + offset)
    x, y = buf_x[offset:], buf_y[offset:]
    with ops.reference_mode():
        want = ops.axpy(-1.75, x, y)
    ops.reset_launch_counts()
    got = ops.axpy(-1.75, x, y)
    assert ops.launch_counts()["blas1_axpy"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# bgemm's batched launch (csrc/gemm_sm90.cu with a batch coordinate,
# csrc/gemm_batched.cu): a per-member B, any out_dtype
# --------------------------------------------------------------------------

# (batch, m, k, n): the MoE decode and prefill rows a member (32, 64) at a
# small width, a ragged fringe in every dimension, one row, K of one k-step,
# one member with 33 rows and an odd K (bf16 staged), 64 members of 65 rows
BATCHED_SHAPES = [(4, 32, 128, 96), (3, 64, 256, 64), (5, 13, 37, 53), (2, 70, 136, 200),
                  (6, 1, 64, 8), (3, 100, 16, 24), (1, 33, 131, 72), (64, 65, 72, 40)]
# (A dtype, out dtype): the served pairs first, then every other output dtype
BATCHED_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                  (torch.float32, torch.float32), (torch.float64, torch.float64),
                  (torch.bfloat16, torch.float64), (torch.bfloat16, torch.float16),
                  (torch.float32, torch.bfloat16), (torch.float32, torch.float64),
                  (torch.float64, torch.float32), (torch.float32, torch.float16)]
BATCHED_EPILOGUES = [(None, False, False, False), ("silu", False, True, False),
                     ("gelu", True, False, True), ("relu", True, True, True)]


def _batched_case(gen, dtype, batch, m, k, n, act, bias, gate, res, shared=False):
    lead = () if shared else (batch,)
    a = _rand(gen, dtype, batch, m, k)
    b = _rand(gen, dtype, *lead, k, n, std=k ** -0.5)
    kw = dict(activation=act)
    if gate:
        kw["b2"] = _rand(gen, dtype, *lead, k, n, std=k ** -0.5)
    if bias:
        kw["bias"] = _rand(gen, dtype, n)
    if res:
        kw["residual"] = _rand(gen, dtype, batch, m, n)
    return a, b, kw


def _out_tol(dtype, out_dtype):
    """The coarser of the operands' and the output's tolerance (f16: one
    rounding step of |y| ~ 4, as bf16's)."""
    tols = [TOL.get(d, TOL[torch.bfloat16]) for d in (dtype, out_dtype)]
    return max(tols, key=lambda t: t["rtol"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", BATCHED_DTYPES)
@pytest.mark.parametrize("batch,m,k,n", BATCHED_SHAPES)
@pytest.mark.parametrize("act,bias,gate,res", BATCHED_EPILOGUES)
def test_batched_bgemm_matches_plain(cuda, dtype, out_dtype, batch, m, k, n, act, bias, gate,
                                     res):
    """One launch over the batch on the route `gemm.plan_batched` names
    (bf16 with N % 8 == 0 and bf16 or f32 out: "wgmma", staged where K %
    8 != 0; f64 out from f64: "dmma"; f32 out from f32: "ffma_sm90", on
    staged operands where K or N is not a multiple of 4; the rest
    "ffma"), in out_dtype, within
    tolerance of the plain version, and bitwise a second launch."""
    from repro_torch.kernels import gemm
    a, b, kw = _batched_case(cuda, dtype, batch, m, k, n, act, bias, gate, res)
    p = gemm.plan_batched(batch, m, k, n, dtype, out_dtype, gate=gate)
    ops.reset_launch_counts()
    got = ops.bgemm(a, b, out_dtype=out_dtype, **kw)
    counts = ops.launch_counts()
    assert (counts["bgemm_batched"], counts[f"bgemm_batched_{p.route}"], counts["bgemm"],
            counts["bgemm_batched_staged"]) == (1, 1, 0, int(p.stage))
    assert got.dtype == out_dtype and got.shape == (batch, m, n)
    with ops.reference_mode():
        want = ops.bgemm(a, b, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want.double(), **_out_tol(dtype, out_dtype))
    assert torch.equal(ops.bgemm(a, b, out_dtype=out_dtype, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("off", ["a", "b"])
def test_batched_bgemm_off_16_bytes_takes_the_staged_wgmma_route(cuda, out_dtype, off):
    """A bf16 A (or B, B2) that starts off a 16-byte boundary (TMA cannot
    address it in place): the batched launch runs the tensor-core kernel on
    a copy of that operand in rows TMA can address (`Plan.stage`), within
    TOL of the plain version, bitwise a second launch."""
    from repro_torch.kernels import gemm
    batch, m, k, n = 4, 32, 128, 96

    def operand(shift: int, *shape, std=1.0):  # shift: elements past an aligned base
        flat = _rand(cuda, torch.bfloat16, int(np.prod(shape)) + shift, std=std)
        return flat[shift:].view(*shape)

    a = operand(int(off == "a"), batch, m, k)
    b, b2 = (operand(int(off == "b"), batch, k, n, std=k ** -0.5) for _ in range(2))
    p = gemm.plan_batched(batch, m, k, n, torch.bfloat16, out_dtype, gate=True,
                          a_aligned=off != "a", b_aligned=off != "b")
    assert (p.route, p.stage) == ("wgmma", True)
    ops.reset_launch_counts()
    got = ops.bgemm(a, b, b2=b2, activation="silu", out_dtype=out_dtype)
    counts = ops.launch_counts()
    assert (counts["bgemm_batched_wgmma"], counts["bgemm_batched_staged"]) == (1, 1)
    with ops.reference_mode():
        want = ops.bgemm(a, b, b2=b2, activation="silu", out_dtype=out_dtype)
    torch.testing.assert_close(got.double(), want.double(),
                               **_out_tol(torch.bfloat16, out_dtype))
    assert torch.equal(ops.bgemm(a, b, b2=b2, activation="silu", out_dtype=out_dtype), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32),
                                             (torch.float64, torch.float64),
                                             (torch.float32, torch.float64)])
@pytest.mark.parametrize("k", [64, 67])
def test_batched_bgemm_with_a_shared_b_matches_plain(cuda, dtype, out_dtype, k):
    """A (k, n) B shared by every member with an out_dtype given: the
    batched launch reads member 0's B for all, on each route (K = 67: bf16
    staged, f64 on 8-byte copies, f32 on the CUDA-core tile)."""
    from repro_torch.kernels import gemm
    a, b, kw = _batched_case(cuda, dtype, 3, 40, k, 72, "silu", True, True, True, shared=True)
    route = gemm.plan_batched(3, 40, k, 72, dtype, out_dtype, gate=True).route
    ops.reset_launch_counts()
    got = ops.bgemm(a, b, out_dtype=out_dtype, **kw)
    with ops.reference_mode():
        want = ops.bgemm(a, b, out_dtype=out_dtype, **kw)
    counts = ops.launch_counts()
    assert (counts["bgemm_batched"], counts[f"bgemm_batched_{route}"]) == (1, 1)
    torch.testing.assert_close(got.double(), want.double(), **_out_tol(dtype, out_dtype))
    assert torch.equal(ops.bgemm(a, b, out_dtype=out_dtype, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gate", [False, True])
def test_batched_wgmma_every_tile(cuda, out_dtype, gate):
    """Every tile of the tensor-core kernel's batched form, both output
    types, through `gemm.tc` directly: a member's fringe rows and
    columns load zeros, never the next member's (each member's B is
    shifted, so a leak shows)."""
    from repro_torch.kernels import gemm
    batch, m, k, n = 3, 70, 200, 136
    a, b, kw = _batched_case(cuda, torch.bfloat16, batch, m, k, n, "silu" if gate else "gelu",
                             True, gate, True)
    b += torch.arange(batch, device="cuda", dtype=torch.bfloat16)[:, None, None]
    with ops.reference_mode():
        want = ops.bgemm(a, b, out_dtype=out_dtype, **kw)
    for tile in gemm.BATCHED_TILES:
        out = torch.empty(batch, m, n, dtype=out_dtype, device="cuda")
        gemm.tc(a, b, out, gemm.Plan("wgmma", tile), b2=kw.get("b2"), bias=kw["bias"],
                residual=kw["residual"], act_code=ops._ACTS[kw["activation"]], m=m, k=k, n=n,
                batch=batch)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BLAS_DTYPES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("gate", [False, True])
def test_packed_batched_bgemm_matches_plain(cuda, dtype, transpose, gate):
    """Packed expert stacks (E, k, n) with per-expert block scales ("kn",
    `quantize_weights`' expert rule, and "nk"): one batched launch on the
    route `gemm.plan_batched` names (bf16 "kn": the tensor cores; f32 A
    with f32 out, either layout: the f32 ring; f64 A with f64 out: the f64
    tensor cores; the rest the CUDA-core tile), out in A's dtype and in
    f32, within TOL of the plain version."""
    from repro_torch.kernels import gemm
    e, m, k, n = 4, 32, 128, 96
    spec = quant.QuantSpec(64, None, transpose=transpose)
    a = _rand(cuda, dtype, e, m, k)
    qb = quant.quantize(_rand(cuda, torch.float32, e, k, n), spec)
    qb2 = quant.quantize(_rand(cuda, torch.float32, e, k, n), spec) if gate else None
    for out_dtype in (dtype, torch.float32):
        route = gemm.plan_batched(e, m, k, n, dtype, out_dtype, gate=gate,
                                  packed_layout=gemm.packed_layout(qb), block=qb.block).route
        assert route == ("wgmma" if dtype == torch.bfloat16 and not transpose
                         else "ffma_sm90" if dtype == out_dtype == torch.float32
                         else "dmma" if dtype == out_dtype == torch.float64 else "ffma")
        ops.reset_launch_counts()
        got = ops.bgemm(a, qb, b2=qb2, activation="silu" if gate else None, out_dtype=out_dtype)
        counts = ops.launch_counts()
        assert (counts["bgemm_batched_int8"], counts[f"bgemm_batched_{route}"]) == (1, 1)
        with ops.reference_mode():
            want = ops.bgemm(a, qb, b2=qb2, activation="silu" if gate else None,
                             out_dtype=out_dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.double(), want.double(), **_out_tol(dtype, out_dtype))


# (members, rows a member, k, n, block_m, block_n, shared B): the expert
# rule's one scale across N; scales that vary along N (and in a block that
# ends inside a tile); two k-steps a scale row; ragged rows and columns; one
# member; 64 members; a B shared by every member
PACKED_KN_CASES = [(4, 32, 256, 96, 64, None, False), (3, 33, 256, 160, 64, 32, False),
                   (2, 65, 384, 144, 128, 48, False), (1, 1, 128, 48, 64, 16, False),
                   (64, 32, 192, 64, 64, None, False), (3, 40, 128, 80, 64, 40, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n,block_m,block_n,shared", PACKED_KN_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act,bias,gate,res", BATCHED_EPILOGUES)
def test_packed_kn_batched_on_wgmma_matches_plain(cuda, e, m, k, n, block_m, block_n, shared,
                                                  out_dtype, act, bias, gate, res):
    """bf16 A against packed "kn" stacks on the tensor cores, each k-step
    scaled by its scale row as it is promoted, at scales that vary along K
    and along N: within TOL of the plain version (which dequantizes B in
    f32), counted as packed and on "wgmma", bitwise a second launch."""
    from repro_torch.kernels import gemm
    spec = quant.QuantSpec(block_m, block_n)
    lead = () if shared else (e,)
    a = _rand(cuda, torch.bfloat16, e, m, k)
    # each block's scale differs: scale rows along K and columns along N
    ramp = torch.linspace(0.25, 4.0, k * n, device="cuda").view(k, n)
    qb, qb2 = (quant.quantize(_rand(cuda, torch.float32, *lead, k, n, std=k ** -0.5) * ramp,
                              spec) for _ in range(2))
    kw = dict(b2=qb2 if gate else None, activation=act,
              bias=_rand(cuda, torch.bfloat16, n) if bias else None,
              residual=_rand(cuda, torch.bfloat16, e, m, n) if res else None)
    p = gemm.plan_batched(e, m, k, n, torch.bfloat16, out_dtype, gate=gate, packed_layout="kn",
                          block=qb.block)
    assert (p.route, p.stage) == ("wgmma", False)
    ops.reset_launch_counts()
    got = ops.bgemm(a, qb, out_dtype=out_dtype, **kw)
    counts = ops.launch_counts()
    assert (counts["bgemm_batched_wgmma"], counts["bgemm_batched_int8"]) == (1, 1)
    with ops.reference_mode():
        want = ops.bgemm(a, qb, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want.double(),
                               **_out_tol(torch.bfloat16, out_dtype))
    assert torch.equal(ops.bgemm(a, qb, out_dtype=out_dtype, **kw), got)


@pytest.mark.cuda
def test_a_batched_launch_the_kernels_refuse_raises(cuda):
    """What the tensor-core kernel does not take comes back as an error and
    the wrapper raises: a K split with a batch, a 128 x 128 tile with a
    batch (the batched form has BN = 64 only), an f32 output at an odd
    N, a packed "kn" B on a 128-row tile or with scale blocks inside a
    k-step."""
    from repro_torch.kernels import gemm
    a, b = _rand(cuda, torch.bfloat16, 2, 64, 256), _rand(cuda, torch.bfloat16, 2, 256, 64)
    kw = dict(b2=None, bias=None, residual=None, act_code=0, m=64, k=256, n=64, batch=2)
    out = torch.empty(2, 64, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, b, out, gemm.Plan("wgmma", (64, 64), splits=2), **kw)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, b, out, gemm.Plan("wgmma", (128, 128)), **kw)
    b63 = _rand(cuda, torch.bfloat16, 2, 256, 64)[..., :63]
    out63 = torch.empty(2, 64, 63, dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, b63, out63, gemm.Plan("wgmma", (64, 64)), **dict(kw, n=63))
    with pytest.raises(TypeError, match="out_dtype"):
        ops.bgemm(a, b, out_dtype=torch.int32)
    # packed "kn" B: 64 x 64 tiles only, and a scale block of whole k-steps
    qb = quant.quantize(_rand(cuda, torch.float32, 2, 256, 64), quant.QuantSpec(64, None))
    packed = dict(kw, scales=qb.scales, qa=64, qb=64)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, qb.values, out, gemm.Plan("wgmma", (128, 64)), **packed)
    with pytest.raises(RuntimeError, match="tensor-core"):
        gemm.tc(a, qb.values, out, gemm.Plan("wgmma", (64, 64)), **dict(packed, qa=32))


@pytest.mark.cuda
def test_moe_smoke_serves_match_the_plain_path(cuda):
    """moonshot and grok SMOKE (f32) serve the same greedy tokens through the
    kernels as through the plain versions; every expert launch batched."""
    from repro_torch.launch.serve import serve
    rng = np.random.default_rng(0)
    for arch in ("moonshot-v1-16b-a3b", "grok-1-314b"):
        prompts = [rng.integers(3, 512, size=(n,), dtype=np.int32) for n in (8, 14, 5)]
        kw = dict(batch=2, gen_lens=[4, 6, 3], eos=-1, prompts=prompts, verbose=False,
                  device="cuda")
        ops.reset_launch_counts()
        got = serve(arch, "smoke", **kw)
        assert ops.launch_counts()["bgemm_batched"] > 0
        with ops.reference_mode():
            want = serve(arch, "smoke", **kw)
        assert got["outputs"] == want["outputs"], arch
