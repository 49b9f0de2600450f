"""The autograd boundary of the kernel wrappers.

A hand-written kernel fills its output through a ctypes launch, which
autograd cannot see: the output would come back cut from the graph, and
a loss on the card would silently drop the gradient of every parameter
upstream of the kernel.  :func:`with_grad` keeps the graph whole.  The
forward is the kernel's own launch, unchanged; the backward recomputes
the wrapper's plain version (``kernels/ref.py``) from the saved inputs
and differentiates it.  That is the backward the JAX package has: none
of its Pallas kernels defines a ``custom_vjp``, and it trains through
plain XLA.  A backward kernel is later work.

Without grad mode, or when no floating input requires grad, the kernel
is called directly, so the serving engines' ``no_grad`` paths pay
nothing for this."""
from __future__ import annotations

from typing import Callable

import torch


def needs_graph(*inputs: torch.Tensor) -> bool:
    """Grad mode is on and some floating input requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in inputs if t.is_floating_point())


def with_grad(kernel: Callable, plain: Callable, *inputs: torch.Tensor):
    """``kernel(*inputs)``, made differentiable through ``plain``, the
    same function in plain PyTorch, when :func:`needs_graph`.  Both take
    the tensors ``inputs`` positionally (bind other arguments in the
    callables) and return a tensor or a tuple of tensors; integer
    outputs are marked non-differentiable."""
    if not needs_graph(*inputs):
        return kernel(*inputs)
    return KernelGrad.apply(kernel, plain, *inputs)


class KernelGrad(torch.autograd.Function):
    """Forward: the kernel.  Backward: the gradient of the plain version,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        out = kernel(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.mark_non_differentiable(
            *(o for o in outs if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        wanted = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(w) if w else x.detach()
                      for x, w in zip(inputs, wanted)]
            out = ctx.plain(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            targets = [x for x, w in zip(leaves, wanted) if w]
            found = iter(torch.autograd.grad(
                [o for o, _ in pairs], targets, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(targets))
        return (None, None, *(next(found) if w else None for w in wanted))
