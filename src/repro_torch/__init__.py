"""PyTorch/CUDA port of the dense greedy serving path of `repro`.

The JAX package `repro` is the reference; this package mirrors its module
names (`configs`, `core.blas`, `core.epilogue`, `kernels.ops`,
`models.layers`, `models.transformer`, `launch.steps`, `launch.serve`) so a
reader finds each counterpart.  The three kernels on the serving path
(batched GEMV, batched GEMM, flash attention) are CUDA C++ for Hopper
(`csrc/`), built with nvcc at first use; CPU tensors take each kernel's
plain PyTorch version.  `core.blas` also carries the BLAS library (dot,
nrm2, axpy, gemv, gemm) over its own gemm, gemv and blas1 kernels.
"""
