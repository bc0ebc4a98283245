"""Staged parameter freezing and gradual release
(``fvt_tpu/train/param_control.py``).

``fvt_tpu`` freezes through ``optax.multi_transform`` with
``set_to_zero``: a frozen leaf gets no update at all, no weight decay and
no momentum.  Here the optimizer is built over the trainable parameters
only, which is the same: a parameter outside it is never touched.  (A
trainable parameter that the loss does not reach is another case: it
stays in the optimizer, and its zero gradient still decays it,
``train/steps.py``.)

Patterns are regular expressions over ``fvt_tpu``'s '/'-joined flax
parameter paths (``temporal_vggish/block0/conv1/v``, ``bn_bert/bn/scale``,
``regressor/dense/kernel``), so a user's patterns freeze the same tensors
in both packages: each port parameter is matched through its flax path
(``from_jax.flax_place``, the bridge's table), never through its torch
name.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from fvt_tpu_torch.models.from_jax import flax_place
from fvt_tpu_torch.train import optim


def flax_path(name: str) -> str:
    """``fvt_tpu``'s '/'-joined params path of the port parameter
    ``name`` (KeyError for a name the bridge does not map)."""
    collection, path, _ = flax_place(name)
    if collection != 'params':
        raise KeyError(f'{name} is a {collection} leaf, not a parameter')
    return '/'.join(path)


def path_mask(params: Mapping[str, torch.Tensor],
              patterns: Sequence[str]) -> Dict[str, bool]:
    """{name: trainable} over ``params`` (the trainable named parameters,
    ``steps.split_frozen(model)[0]``): True where the parameter's flax
    path matches any regex of ``patterns``; no patterns, all True."""
    if not patterns:
        return {name: True for name in params}
    regexes = [re.compile(p) for p in patterns]
    return {name: any(r.search(flax_path(name)) for r in regexes)
            for name in params}


def freeze(hp, params: Mapping[str, torch.nn.Parameter],
           trainable_patterns: Sequence[str]) -> torch.optim.Optimizer:
    """The optimizer of ``hp`` over the parameters of ``params`` that
    match the patterns; the others get no update."""
    mask = path_mask(params, trainable_patterns)
    # a parameter group, so that an empty selection builds too
    return optim.build_optimizer(
        hp, [{'params': [p for name, p in params.items() if mask[name]]}])


class ParamControl:
    """Gradual release with the upstream ResnetParamControl's semantics:
    ``base_patterns`` (the head) train from the start; no staged group is
    unlocked until the first ``release()``; each release unlocks the first
    remaining group; once the stack or ``release_count`` is exhausted, a
    further release sets ``early_stop`` (the trainer halts) instead."""

    def __init__(self, stage_patterns: List[List[str]],
                 release_count: int = 3,
                 base_patterns: Optional[List[str]] = None):
        self.stage_patterns = stage_patterns
        self.base_patterns = list(base_patterns or [])
        self.release_count = release_count
        self.released = 0
        self.early_stop = False

    def current_patterns(self) -> List[str]:
        out: List[str] = list(self.base_patterns)
        for group in self.stage_patterns[:self.released]:
            out.extend(group)
        return out

    def can_release(self) -> bool:
        return (not self.early_stop and self.release_count > 0
                and self.released < len(self.stage_patterns))

    def release(self, hp, params: Mapping[str, torch.nn.Parameter]
                ) -> torch.optim.Optimizer:
        if not self.can_release():
            self.early_stop = True
            return freeze(hp, params, self.current_patterns())
        self.released += 1
        self.release_count -= 1
        return freeze(hp, params, self.current_patterns())
