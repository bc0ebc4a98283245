"""Weight bridge, the other way: a state_dict of the port's LFAN, CAN,
JMT or MT -> ``fvt_tpu``'s flax ``params`` and ``batch_stats`` trees.

:func:`flax_from_state` is the inverse of ``from_jax.state_from_flax``:
each key goes where ``from_jax.LAYOUT`` puts it, with its layout
conversion (Linear weight (out, in) -> Dense kernel (in, out);
weight-norm ``weight_v`` (out, in, K) -> v (K, in, out) and ``weight_g``
(out, 1, 1) -> g (out,); the downsample's (out, in, 1) ->
``proj/dense/kernel`` (in, out); ``in_proj_weight`` -> ``in_proj_kernel``;
BatchNorm1d -> ``scale``/``bias`` and ``batch_stats`` ``mean``/``var``;
``num_batches_tracked`` has no flax counterpart and is dropped).  The
frozen ArcFace of a ``video`` model goes to ``spatial_video/backbone``
(:func:`arcface_flax_from_state`, the inverse of ``from_jax._arcface``):
conv kernels OIHW -> HWIO, PReLU slopes to ``alpha``, ``output_linear``
from PyTorch's NCHW flatten back to ``fvt_tpu``'s NHWC one, and its 54
BatchNorms' parameters and statistics.  The frozen VGGish of a
``logmel`` model goes to ``spatial_audio`` (:func:`vggish_flax_from_state`,
the inverse of ``from_jax.vggish_state_from_flax``): conv kernels OIHW ->
HWIO, Linear weights transposed, no statistics.  Every dict is keyed in sorted
order, as ``jax.tree.map`` leaves it, so the trees serialise to the bytes
``fvt_tpu`` writes.  :func:`act_scales_to_flax` gives the calibrated
amaxes of an int8 ArcFace as ``fvt_tpu``'s ``act_scales`` collection.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from fvt_tpu_torch.models.arcface import get_blocks_50
from fvt_tpu_torch.models.from_jax import (AUDIO_PREFIX, MODULE_PORT_RULES,
                                           NO_FLAX, VGGISH_EMBEDDINGS,
                                           flax_place)
from fvt_tpu_torch.models.vggish import feature_indices


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to('cpu', torch.float32).numpy())


def sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
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
        seen.add(f'{prefix}.{key}.{NO_FLAX}')

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
    return sorted_tree(params), sorted_tree(stats)


def vggish_flax_from_state(state: Mapping[str, torch.Tensor],
                           prefix: str) -> dict:
    """Params of ``fvt_tpu``'s ``VGGish`` from the keys ``<prefix>.*``
    of ``state`` (the port's ``VGGish``).  Raises on a key under
    ``prefix`` it does not map."""
    params: Dict[str, dict] = {}
    seen = set()

    def take(key):
        seen.add(f'{prefix}.{key}')
        return _np(state[f'{prefix}.{key}'])

    for i, idx in enumerate(feature_indices()):
        params[f'conv{i}'] = {
            'bias': take(f'features.{idx}.bias'),
            'kernel': np.ascontiguousarray(
                take(f'features.{idx}.weight').transpose(2, 3, 1, 0))}
    for j, idx in enumerate(VGGISH_EMBEDDINGS):
        params[f'fc{j}'] = {
            'bias': take(f'embeddings.{idx}.bias'),
            'kernel': np.ascontiguousarray(
                take(f'embeddings.{idx}.weight').T)}
    left = [k for k in state if k.startswith(prefix + '.') and k not in seen]
    if left:
        raise KeyError(f'{left[:3]}: no counterpart in fvt_tpu\'s VGGish '
                       f'tree')
    return sorted_tree(params)


def flax_from_state(state: Mapping[str, torch.Tensor],
                    modality: Optional[Sequence[str]] = None
                    ) -> Tuple[dict, dict]:
    """(params, batch_stats) of ``fvt_tpu``'s model from the port's LFAN,
    CAN, JMT or MT state_dict ``state``.  A ``video`` model's
    ``spatial.visual.backbone.*`` goes to ``spatial_video/backbone``, a
    ``logmel`` model's ``spatial.audio.backbone.*`` to ``spatial_audio``.
    Raises on a key it does not map, so nothing of the model is left out
    silently, and where ``modality`` is given, on a TCN of another
    modality."""
    trees: Dict[str, dict] = {'params': {}, 'batch_stats': {}}
    visual = 'spatial.visual.backbone'
    if any(k.startswith(visual + '.') for k in state):
        p, st = arcface_flax_from_state(state, visual)
        trees['params']['spatial_video'] = {'backbone': p}
        trees['batch_stats']['spatial_video'] = {'backbone': st}
    if any(k.startswith(AUDIO_PREFIX + '.') for k in state):
        trees['params']['spatial_audio'] = vggish_flax_from_state(
            state, AUDIO_PREFIX)
    for key, tensor in state.items():
        if key.startswith((visual + '.', AUDIO_PREFIX + '.')) \
                or key.endswith(NO_FLAX):
            continue
        collection, path, to_flax = flax_place(key)
        if modality is not None and path[0].startswith('temporal_') \
                and path[0][len('temporal_'):] not in modality:
            raise KeyError(f'{key}: a TCN of none of {list(modality)}')
        value = _np(tensor)
        _put(trees[collection], path, np.ascontiguousarray(
            to_flax(value) if to_flax else value))
    return sorted_tree(trees['params']), sorted_tree(trees['batch_stats'])



def module_flax_from_state(state: Mapping[str, torch.Tensor]) -> dict:
    """Params of the ``fvt_tpu`` counterpart of one of the port's
    ``models/fusion_extra.py`` modules from its state_dict (the inverse
    of ``from_jax.module_state_from_flax``)."""
    params: Dict[str, dict] = {}
    for key, tensor in state.items():
        _, path, to_flax = flax_place(key, MODULE_PORT_RULES)
        value = _np(tensor)
        _put(params, path, np.ascontiguousarray(
            to_flax(value) if to_flax else value))
    return sorted_tree(params)


def act_scales_to_flax(model) -> dict:
    """``fvt_tpu``'s ``act_scales`` collection of a ``video`` model whose
    ArcFace serves static int8: ``{'spatial_video': {'backbone':
    {'body<i>': {'conv<j>': {'amax': 0-d float32}}}}}``, keyed in sorted
    order (``from_jax.load_act_scales`` the other way)."""
    return sorted_tree({'spatial_video': model.spatial.visual.act_scales()})
