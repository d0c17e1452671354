"""Operand precision of the reference's products.

"f32" is the reference itself (TF32 off). The controls run the same code
with the operands of every product rounded first: "tf32" to TF32's 10-bit
mantissa (the step below float32 training), "fp8" to float8 e4m3 with one
scale per row of the left operand and per column of the right one (the
step below bfloat16 serving). The rounding is done here, not by the card,
so a control reads the same on any device. In training the forward
products take the rounded operands and the backward passes the rounding
straight through."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0
MODES = ("f32", "tf32", "fp8")


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 for the block's duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _tf32(x):
    b = x.detach().contiguous().view(torch.int32)
    r = ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    # the gradient passes the rounding unchanged
    return x + (r - x).detach() if x.requires_grad else r


def _fp8(x, dim):
    s = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) \
        / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Prec:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}: expected one of {MODES}")
        self.mode = mode

    def left(self, a):
        """a [..., k] as the left operand of a product over k."""
        a = a.float()
        if self.mode == "tf32":
            return _tf32(a)
        if self.mode == "fp8":
            return _fp8(a, -1)
        return a

    def right(self, b):
        """b [..., k, n] as the right operand of a product over k."""
        b = b.float()
        if self.mode == "tf32":
            return _tf32(b)
        if self.mode == "fp8":
            return _fp8(b, -2)
        return b

    def mm(self, a, b):
        return self.left(a) @ self.right(b)
