"""Parameter utilities: counts, the global norm and freezing.

Port of ``generative_physics_informed_pde_tpu/utils/params.py`` for the
port's parameter containers: a module (its ``named_parameters()``) or a
nested dict of tensors, whose leaves are named by their dotted paths
(``f.Conv_0.weight``, ``q_z.supervised.mean``).  A name is frozen when any
of its dotted components is one of the given keys, as the JAX package
matches path keys.  Freezing gives a parameter exactly zero change: the
inner optimizer sees only the trainable parameters, so it keeps no state
for the frozen ones (optax's ``multi_transform`` with ``set_to_zero``,
which does not advance Adam's moments there either).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch


def _named_leaves(params) -> Dict[str, object]:
    """Dotted name -> leaf of a module or a nested dict of tensors."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    out = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = val
    walk(params, "")
    return out


def count_parameters(params) -> int:
    """Total number of scalar parameters."""
    return sum(int(np.prod(np.shape(v))) for v in
               _named_leaves(params).values())


def global_norm(params) -> torch.Tensor:
    """L2 norm over all leaves (of a module's parameters, or of a
    gradient dict)."""
    leaves = [torch.as_tensor(v) for v in _named_leaves(params).values()]
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves))


def freeze_mask(params, frozen: Union[Sequence[str], Callable]) -> dict:
    """Dotted name -> 'frozen' | 'trainable'.  ``frozen`` is a list of
    keys (a name with any component among them is frozen, e.g. ['f',
    'encoder'] or ['q_z']) or a predicate ``(name, leaf) -> bool``."""
    if callable(frozen):
        pred = frozen
    else:
        keys = set(frozen)
        pred = lambda name, leaf: bool(keys & set(name.split(".")))  # noqa: E731
    return {name: "frozen" if pred(name, leaf) else "trainable"
            for name, leaf in _named_leaves(params).items()}


def freeze_optimizer(optimizer: Callable, params,
                     frozen: Union[Sequence[str], Callable]
                     ) -> torch.optim.Optimizer:
    """``optimizer`` (a callable taking a list of parameters, e.g.
    ``functools.partial(torch.optim.Adam, lr=1e-2)``) built on the
    trainable parameters of ``params`` alone: the frozen ones never
    change, and the trainable ones step as ``optimizer`` would step them
    over all the parameters (the requires_grad=False of the reference)."""
    labels = freeze_mask(params, frozen)
    leaves = _named_leaves(params)
    return optimizer([leaves[n] for n, lab in labels.items()
                      if lab == "trainable"])
