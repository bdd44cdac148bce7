"""Kernels inside autograd: forward through a kernel, backward through the
kernel's plain version.

A kernel launched through ``data_ptr()`` returns a tensor with no autograd
graph, so a loss computed through it would get no gradient at its site.
``differentiable(kernel, reference, *inputs, **options)`` runs ``kernel``
and, when grad mode is on and an input requires grad, wraps the call in a
``torch.autograd.Function`` whose backward recomputes ``reference`` on the
saved inputs and differentiates it (the JAX package's ``jax.vjp`` of the
XLA reference in each kernel's ``custom_vjp``). Otherwise the kernel runs
alone and nothing is saved. Only flash attention has backward kernels of
its own (``flash_attention.py``).

The output may be one tensor or a tuple of them (the GroupNorm fold's (sc,
sh)). ``kernel`` is any callable with the reference's signature: the wrappers pass
their CUDA launch, and the CPU tests pass the plain version itself, which
exercises this wiring without a card.
"""

from __future__ import annotations

from typing import Callable

import torch


class _ReferenceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, reference, options, *inputs):
        ctx.reference, ctx.options = reference, options
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **options)

    @staticmethod
    def backward(ctx, *grad):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, needs)]
            out = ctx.reference(*leaves, **ctx.options)
        outs = out if isinstance(out, tuple) else (out,)
        wrt = [x for x, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(outs, wrt, grad, allow_unused=True))
        return (None, None, None, *(next(grads) if n else None for n in needs))


def differentiable(kernel: Callable, reference: Callable, *inputs: torch.Tensor,
                   **options) -> torch.Tensor:
    """kernel(*inputs, **options), with the gradient of reference(*inputs,
    **options) when one is needed."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _ReferenceGrad.apply(kernel, reference, options, *inputs)
    return kernel(*inputs, **options)
