"""The control's precision: TF32, the step below the float32 that the
configurations state (TF32 off). Inside `tf32()` every float32 matrix
product of the reference (matmul, @, mm, bmm, einsum, and the products
inside cdist) takes its operands rounded to TF32's 10-bit mantissa, as the
tensor cores do, and accumulates in float32; on a CUDA device PyTorch's own
TF32 switches are on as well. The same rounding on the CPU and the card,
so the control's test runs on either."""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum,
             torch.Tensor.mm, torch.Tensor.bmm}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (ties to even), kept in float32."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    out = u.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


class _Tf32(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(round_tf32(a) if isinstance(a, torch.Tensor) else
                         [round_tf32(b) for b in a] if isinstance(a, (list, tuple))
                         and a and isinstance(a[0], torch.Tensor) else a for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32(on: bool = True):
    """The control's precision inside the block (a no-op when `on` is
    false)."""
    if not on:
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with _Tf32():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def fp32_matmul_off():
    """The configurations' precision: float32 products with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
