"""What every CUDA kernel wrapper of the port does around its launch.

A wrapper checks its operands (``operands``), refuses to run under autograd
on tensors that want a gradient (``no_autograd``: a kernel's output carries
no graph, so autograd would silently drop the path), launches through the
plain C interface of its library (``launch``) and raises on a failed launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def no_autograd(op: str, tensors, trainable: str) -> None:
    """Raise when autograd would record through a kernel launch: the
    kernel's output has no grad_fn, so gradients would silently stop."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no autograd rule and an operand "
            f"requires grad; {trainable}")


def operands(op: str, tensors, dtype: torch.dtype, device: torch.device) -> None:
    """Every operand on ``device``, a CUDA device, contiguous and 16-byte
    aligned; float operands of ``dtype``, one the kernels take."""
    if device.type != "cuda":
        raise ValueError(f"{op}: tensors must be on the CPU or a CUDA device; "
                         f"got {device}")
    if dtype not in SUFFIX:
        raise ValueError(f"{op}: unsupported dtype {dtype}; the kernels take "
                         f"{sorted(str(d) for d in SUFFIX)}")
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{op}: operands must share one device; got "
                             f"{t.device} and {device}")
        if t.is_floating_point() and t.dtype != dtype:
            raise ValueError(f"{op}: float operands must be {dtype}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: operands must be 16-byte aligned")


def index32(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """An index map as contiguous int32 on ``device``."""
    return t.to(device=device, dtype=torch.int32).contiguous()


def total_rows_on(total_rows, device: torch.device) -> torch.Tensor:
    """``total_rows`` (an int or a tensor) as a (1,) int32 tensor on the
    device, for the kernel to read there: the host never waits for it."""
    if isinstance(total_rows, torch.Tensor):
        return total_rows.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(total_rows), dtype=torch.int32, device=device)


def _ctype(a):
    if isinstance(a, int):
        return ctypes.c_int
    if isinstance(a, float):
        return ctypes.c_float
    return ctypes.c_void_p


def wrappers() -> tuple:
    """Every kernel wrapper of the port, each counting its launches in
    ``.launches`` (a captured step adds its recorded launches at replay)."""
    from repro_torch.kernels import (adamw_cuda, dispatch_cuda, flash_attention,
                                     fused_moe, grouped_mlp, ragged_mlp, weight_grad)
    return (grouped_mlp.grouped_swiglu, grouped_mlp.grouped_matmul,
            ragged_mlp.ragged_swiglu, ragged_mlp.ragged_matmul,
            fused_moe.fused_moe, dispatch_cuda.scatter_rows,
            dispatch_cuda.gather_combine, weight_grad.segment_outer,
            flash_attention.flash_attention, adamw_cuda.sumsq, adamw_cuda.adamw_step)


def launch(library: str, symbol: str, args: list, device: torch.device) -> None:
    """Call ``symbol`` of ``csrc/<library>.cu`` with ``args`` (tensors, ints,
    floats passed as C floats, or None for a null pointer) on the device's
    current stream; raise on the CUDA error it returns."""
    fn = getattr(build.library(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    values = [a if a is None or isinstance(a, (int, float)) else a.data_ptr()
              for a in args]
    with torch.cuda.device(device):
        rc = fn(*values, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {rc}")
