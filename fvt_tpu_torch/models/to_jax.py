"""Weight bridge, the other way: a state_dict of the port's LFAN ->
``fvt_tpu``'s flax ``params`` and ``batch_stats`` trees.

:func:`lfan_flax_from_state` is the inverse of
``from_jax.lfan_state_from_flax``: Linear weight (out, in) -> Dense kernel
(in, out); weight-norm ``weight_v`` (out, in, K) -> v (K, in, out) and
``weight_g`` (out, 1, 1) -> g (out,); the downsample's (out, in, 1) ->
``proj/dense/kernel`` (in, out); BatchNorm1d -> ``scale``/``bias`` and
``batch_stats`` ``mean``/``var`` (``num_batches_tracked`` has no flax
counterpart and is dropped).  Every dict is keyed in sorted order, as
``jax.tree.map`` leaves it, so the trees serialise to the bytes
``fvt_tpu`` writes.  The feature modalities are covered; the frozen
ArcFace of a ``video`` model is not (tri-modal training, queue A2b).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

_NO_FLAX = 'num_batches_tracked'


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to('cpu', torch.float32).numpy())


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _put(tree: dict, path: Sequence[str], value: np.ndarray) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    if path[-1] in tree:
        raise ValueError(f'{"/".join(path)} written twice')
    tree[path[-1]] = value


def lfan_flax_from_state(state: Mapping[str, torch.Tensor],
                         modality: Sequence[str]) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``fvt_tpu``'s LFAN from the port's LFAN
    state_dict ``state``; ``modality`` is the model's modality order
    (leader first).  Raises on a key it does not map, so nothing of the
    model is left out silently."""
    if any(k.startswith('spatial.') for k in state):
        raise NotImplementedError(
            'writing a video model\'s frozen ArcFace to fvt_tpu\'s tree is '
            'not ported yet: it comes with tri-modal training (queue A2b)')
    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}
    mods = '|'.join(re.escape(m) for m in modality)
    rules = (
        (rf'temporal\.({mods})\.network\.(\d+)\.(conv[12])\.weight_v',
         lambda m, v: (('temporal_' + m[1], f'block{m[2]}', m[3], 'v'),
                       v.transpose(2, 1, 0))),
        (rf'temporal\.({mods})\.network\.(\d+)\.(conv[12])\.weight_g',
         lambda m, v: (('temporal_' + m[1], f'block{m[2]}', m[3], 'g'),
                       v.reshape(-1))),
        (rf'temporal\.({mods})\.network\.(\d+)\.(conv[12])\.bias',
         lambda m, v: (('temporal_' + m[1], f'block{m[2]}', m[3], 'bias'),
                       v)),
        (rf'temporal\.({mods})\.network\.(\d+)\.downsample\.weight',
         lambda m, v: (('temporal_' + m[1], f'block{m[2]}', 'downsample',
                        'proj', 'dense', 'kernel'), v[:, :, 0].T)),
        (rf'temporal\.({mods})\.network\.(\d+)\.downsample\.bias',
         lambda m, v: (('temporal_' + m[1], f'block{m[2]}', 'downsample',
                        'proj', 'dense', 'bias'), v)),
        (rf'bn\.({mods})\.weight',
         lambda m, v: (('bn_' + m[1], 'bn', 'scale'), v)),
        (rf'bn\.({mods})\.bias',
         lambda m, v: (('bn_' + m[1], 'bn', 'bias'), v)),
        (rf'fusion\.layers\.self_attn\.qkv_proj\.({mods})\.weight',
         lambda m, v: (('fusion', 'self_attn', 'qkv_' + m[1], 'dense',
                        'kernel'), v.T)),
        (rf'fusion\.layers\.self_attn\.qkv_proj\.({mods})\.bias',
         lambda m, v: (('fusion', 'self_attn', 'qkv_' + m[1], 'dense',
                        'bias'), v)),
        (r'fusion\.layers\.self_attn\.o_proj\.(weight|bias)',
         lambda m, v: (('fusion', 'self_attn', 'o_proj', 'dense',
                        'kernel' if m[1] == 'weight' else 'bias'),
                       v.T if m[1] == 'weight' else v)),
        (r'fusion\.layers\.norm1\.(weight|bias)',
         lambda m, v: (('fusion', 'norm1',
                        'scale' if m[1] == 'weight' else 'bias'), v)),
        (r'regressor\.(weight|bias)',
         lambda m, v: (('regressor', 'dense',
                        'kernel' if m[1] == 'weight' else 'bias'),
                       v.T if m[1] == 'weight' else v)),
    )
    stat_rule = re.compile(rf'bn\.({mods})\.running_(mean|var)')
    for key, tensor in state.items():
        if key.endswith(_NO_FLAX):
            continue
        m = stat_rule.fullmatch(key)
        if m:
            _put(stats, ('bn_' + m[1], 'bn', m[2]), _np(tensor))
            continue
        for pattern, rule in rules:
            m = re.fullmatch(pattern, key)
            if m:
                path, value = rule(m, _np(tensor))
                _put(params, path, np.ascontiguousarray(value))
                break
        else:
            raise KeyError(f'{key}: no counterpart in fvt_tpu\'s LFAN tree')
    return _sorted(params), _sorted(stats)
