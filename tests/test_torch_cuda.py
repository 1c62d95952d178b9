"""The port's CUDA kernels against their plain versions, on a GPU.

Marked `cuda`: each test skips without a CUDA device (always the case in
the CPU container).  On the GPU machine, which has no jax:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Small ragged and aligned shapes, so both the vector and the element-load
paths of each kernel run (chip_smoke.py holds them at the serving shapes).
Tolerances: f32 rtol = atol = 1e-4 (summation order), bf16 1.6e-2 (one
output rounding step at |y| ~ 4).
"""

import pytest
import torch

from repro_torch.kernels import ops

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.Generator(device="cuda").manual_seed(0)


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
    _against_plain(lambda: ops.bgemv(w, x), dtype)
    _against_plain(lambda: ops.bgemv(w, x, a2=w2, bias=bias, residual=res, activation="silu"), dtype)


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
@pytest.mark.parametrize("d", [16, 64, 128])
def test_attention_kernel_matches_plain(cuda, dtype, d):
    q, kv = _rand(cuda, dtype, 3, 5, 4, d), _rand(cuda, dtype, 3, 24, 2, d)
    kv[1, 12:] = float("nan")  # garbage past slot 1's length
    lens = torch.tensor([5] * 4 + [12] * 4 + [20] * 4, dtype=torch.int32, device="cuda")
    _against_plain(lambda: ops.flash_attention(q, kv, kv, kv_lens=lens, kv_groups=2), dtype)


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda):
    ops.reset_launch_counts()
    w, x = _rand(cuda, torch.float32, 64, 32), _rand(cuda, torch.float32, 2, 64)
    ops.bgemv(w, x)
    ops.bgemm(x[None], w)
    with ops.reference_mode():
        ops.bgemv(w, x)
    assert ops.launch_counts() == {"bgemv": 1, "bgemm": 1, "attention": 0}
