"""AdamW with optax's arithmetic and state, on tensors (port-own).

The JAX package trains with ``optax.adamw(lr)``; the card has no optax, so
this module writes out the same transformation. ``optax.adamw`` is
``chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(wd),
scale_by_learning_rate(lr))`` with its defaults b1 0.9, b2 0.999, eps
1e-8, eps_root 0, **weight_decay 1e-4** (``torch.optim.AdamW`` defaults to
1e-2) and no mask:

    mu    <- b1 mu + (1 - b1) g           nu <- b2 nu + (1 - b2) g^2
    count <- count + 1
    u     <- (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + eps_root) + eps)
    p     <- p - lr (u + wd p)

The state has optax's tree shape, ``(ScaleByAdamState(count, mu, nu),
EmptyState(), EmptyState())`` (namedtuples, so ``utils/pytree.py`` walks
them as JAX does: ``opt_state/0/.mu/...``), which lets a train-state
checkpoint cross packages (``runtime/checkpoint.py``; ``models/convert.py``
maps ``mu`` / ``nu`` between the port's names and flax paths as it maps
params). ``count`` is an int32 0-d tensor; ``mu`` / ``nu`` are dicts keyed
like the params, f32.

:meth:`AdamW.apply_` is optax's ``update`` followed by ``apply_updates``,
in place: it updates the moments and the params with ``torch._foreach_*``
ops, in groups of at most :data:`CHUNK` elements so the temporaries stay
small beside the state. Not a TPU kernel: optax's update is XLA.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

#: Elements a group of the in-place update handles at once.
CHUNK = 1 << 28


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class EmptyState(NamedTuple):
    pass


OptState = Tuple[ScaleByAdamState, EmptyState, EmptyState]


class AdamW:
    """``optax.adamw``'s transformation (see the module docstring)."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 1e-4) -> None:
        self.lr = float(learning_rate)
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)
        self.weight_decay = float(weight_decay)

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        """Zero moments shaped like ``params``; count 0."""
        dev = next(iter(params.values())).device if params else "cpu"
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in params.items()}
        return (ScaleByAdamState(
            torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros()),
            EmptyState(), EmptyState())

    def _corrections(self, count: torch.Tensor) -> Tuple[float, float]:
        c = float(count.item())
        return 1.0 - self.b1 ** c, 1.0 - self.b2 ** c

    @torch.no_grad()
    def apply_(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: OptState) -> OptState:
        """One step in place: moments, count and params. Returns ``state``
        (the same tensors, updated)."""
        adam = state[0]
        adam.count.add_(1)
        bc1, bc2 = self._corrections(adam.count)
        groups, cur, size = [], [], 0
        for n in (n for n in params if n in grads):
            if cur and size + params[n].numel() > CHUNK:
                groups.append(cur)
                cur, size = [], 0
            cur.append(n)
            size += params[n].numel()
        if cur:
            groups.append(cur)
        for g in groups:
            self._apply_group([params[n] for n in g],
                              [grads[n].float() for n in g],
                              [adam.mu[n] for n in g],
                              [adam.nu[n] for n in g], bc1, bc2)
        return state

    def _apply_group(self, ps, gs, mus, nus, bc1: float, bc2: float) -> None:
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1 - self.b2)
        denom = torch._foreach_div(nus, bc2)
        if self.eps_root:
            torch._foreach_add_(denom, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-self.lr)


def adamw(learning_rate: float, **kwargs) -> AdamW:
    """``optax.adamw(learning_rate, **kwargs)``'s counterpart."""
    return AdamW(learning_rate, **kwargs)
