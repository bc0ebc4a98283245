"""Weight bridge, the other way: a state_dict of the port's LFAN ->
``fvt_tpu``'s flax ``params`` and ``batch_stats`` trees.

:func:`lfan_flax_from_state` is the inverse of
``from_jax.lfan_state_from_flax``: Linear weight (out, in) -> Dense kernel
(in, out); weight-norm ``weight_v`` (out, in, K) -> v (K, in, out) and
``weight_g`` (out, 1, 1) -> g (out,); the downsample's (out, in, 1) ->
``proj/dense/kernel`` (in, out); BatchNorm1d -> ``scale``/``bias`` and
``batch_stats`` ``mean``/``var`` (``num_batches_tracked`` has no flax
counterpart and is dropped).  The frozen ArcFace of a ``video`` model goes
to ``spatial_video/backbone`` (:func:`arcface_flax_from_state`, the
inverse of ``from_jax._arcface``): conv kernels OIHW -> HWIO, PReLU
slopes to ``alpha``, ``output_linear`` from PyTorch's NCHW flatten back
to ``fvt_tpu``'s NHWC one, and its 54 BatchNorms' parameters and
statistics.  Every dict is keyed in sorted order, as ``jax.tree.map``
leaves it, so the trees serialise to the bytes ``fvt_tpu`` writes.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from fvt_tpu_torch.models.arcface import get_blocks_50

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


def arcface_flax_from_state(state: Mapping[str, torch.Tensor],
                            prefix: str) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``fvt_tpu``'s ``ArcFaceBackbone`` from the
    keys ``<prefix>.*`` of ``state`` (the port's ``Backbone``).  Raises on a
    key under ``prefix`` it does not map."""
    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}
    seen = set()

    def take(key):
        seen.add(f'{prefix}.{key}')
        return _np(state[f'{prefix}.{key}'])

    def conv(key, path):
        # OIHW -> HWIO
        _put(params, path + ('kernel',), np.ascontiguousarray(
            take(f'{key}.weight').transpose(2, 3, 1, 0)))

    def bn(key, path):
        _put(params, path + ('scale',), take(f'{key}.weight'))
        _put(params, path + ('bias',), take(f'{key}.bias'))
        _put(stats, path + ('mean',), take(f'{key}.running_mean'))
        _put(stats, path + ('var',), take(f'{key}.running_var'))
        seen.add(f'{prefix}.{key}.{_NO_FLAX}')

    conv('input_layer.0', ('input_conv',))
    bn('input_layer.1', ('input_bn',))
    _put(params, ('input_prelu', 'alpha'), take('input_layer.2.weight'))
    for i, (in_c, depth, _) in enumerate(get_blocks_50()):
        base, blk = f'body.{i}', (f'body{i}',)
        if in_c != depth:
            conv(f'{base}.shortcut_layer.0', blk + ('shortcut_conv',))
            bn(f'{base}.shortcut_layer.1', blk + ('shortcut_bn',))
        bn(f'{base}.res_layer.0', blk + ('bn1',))
        conv(f'{base}.res_layer.1', blk + ('conv1',))
        _put(params, blk + ('prelu', 'alpha'),
             take(f'{base}.res_layer.2.weight'))
        conv(f'{base}.res_layer.3', blk + ('conv2',))
        bn(f'{base}.res_layer.4', blk + ('bn2',))
    bn('output_layer.0', ('output_bn2d',))
    # PyTorch flattens NCHW (c*25 + h*5 + w); fvt_tpu NHWC (h*2560 + w*512
    # + c): the Linear's columns permuted, then (out, in) -> (in, out)
    w = take('output_layer.3.weight')
    w = w.reshape(512, 512, 5, 5).transpose(0, 2, 3, 1).reshape(512, -1)
    _put(params, ('output_linear', 'kernel'), np.ascontiguousarray(w.T))
    _put(params, ('output_linear', 'bias'), take('output_layer.3.bias'))
    bn('output_layer.4', ('output_bn1d',))
    left = [k for k in state if k.startswith(prefix + '.') and k not in seen]
    if left:
        raise KeyError(f'{left[:3]}: no counterpart in fvt_tpu\'s '
                       f'ArcFaceBackbone tree')
    return _sorted(params), _sorted(stats)


def lfan_flax_from_state(state: Mapping[str, torch.Tensor],
                         modality: Sequence[str]) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``fvt_tpu``'s LFAN from the port's LFAN
    state_dict ``state``; ``modality`` is the model's modality order
    (leader first).  A ``video`` model's ``spatial.visual.backbone.*``
    goes to ``spatial_video/backbone``.  Raises on a key it does not map,
    so nothing of the model is left out silently."""
    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}
    visual = 'spatial.visual.backbone'
    if any(k.startswith(visual + '.') for k in state):
        p, st = arcface_flax_from_state(state, visual)
        params['spatial_video'] = {'backbone': p}
        stats['spatial_video'] = {'backbone': st}
        state = {k: v for k, v in state.items()
                 if not k.startswith(visual + '.')}
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
