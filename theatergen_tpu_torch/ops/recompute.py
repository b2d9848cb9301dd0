"""Gradients of the hand-written kernels by recomputation.

The JAX package makes each Pallas kernel differentiable with a
``custom_vjp`` whose backward runs ``jax.vjp`` of its plain XLA version
(``ops/flash_attention.py:507-543, 666-703``, ``ops/geglu_matmul.py:
517-580``, ``ops/groupnorm.py:128-173``); no backward kernel exists.  The
port does the same with a ``torch.autograd.Function`` per wrapper: its
forward launches the kernel and saves the inputs, its backward recomputes
the plain PyTorch version from them (:func:`plain_vjp`), so the graph of
the plain version lives only inside one backward call at a time.  A
wrapper takes its Function only where :func:`needs_grad` holds, so a call
outside autograd (the serving path) launches as before.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a call on these inputs must record a gradient: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def plain_vjp(plain: Callable[..., torch.Tensor],
              inputs: Sequence[Optional[torch.Tensor]],
              needs: Sequence[bool], grad_out: torch.Tensor,
              **kwargs) -> Tuple[Optional[torch.Tensor], ...]:
    """The vector-Jacobian product of ``plain(*inputs, **kwargs)`` with
    ``grad_out``: one gradient per input, None where ``needs`` is False.
    ``plain`` runs on detached copies of the inputs under grad mode, so
    the graph it records is freed when this returns."""
    leaves = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
    want = [t for t, n in zip(leaves, needs) if n]
    if not want:
        return tuple(None for _ in needs)
    with torch.enable_grad():
        out = plain(*leaves, **kwargs)
    grads = iter(torch.autograd.grad(out, want, grad_out))
    return tuple(next(grads) if n else None for n in needs)
