"""The products' precision of a plain reference network: float32 (the
configurations' precision), or the control's TF32.  Shared by every
network family's reference (``Net(cfg, env, prec)`` takes it)."""

from __future__ import annotations

import torch


class Precision:
    """The products' precision while the context is open: float32 (the
    configurations' precision), or with ``tf32`` the control's TF32: on a
    card the tensor cores' TF32, on the CPU the operands rounded to TF32's
    10 mantissa bits first."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., m, k] @ b [..., k, n], batch dims alike."""
        if self.tf32 and a.device.type == "cpu":
            return _TF32Matmul.apply(a, b)
        return torch.matmul(a, b)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """A product, and its gradients' products, of operands rounded to
    TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_tf32(a), _tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return (torch.matmul(g, _tf32(b).transpose(-1, -2)),
                torch.matmul(_tf32(a).transpose(-1, -2), g))
