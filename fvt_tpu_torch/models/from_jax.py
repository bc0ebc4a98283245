"""Weight bridge: ``fvt_tpu`` flax trees -> a state_dict of the port's LFAN.

:func:`lfan_state_from_flax` takes the flax ``params`` and
``batch_stats`` trees as nested dicts of numpy arrays and returns the
state_dict that :class:`fvt_tpu_torch.models.models.LFAN` loads with
``strict=True``.  Keys and values are those of
``fvt_tpu.models.torch_export.lfan_to_torch`` (legacy weight-norm
naming), less the dead keys that exporter makes up for the upstream
model: the TCN ``net.0`` / ``net.4`` duplicates and
``spatial.visual.logits``.  So a reference ``model.pt`` loads as it is
once those keys are dropped (:data:`DEAD_KEY_PATTERNS`).

Layout conversions: Dense kernel (in, out) -> Linear weight (out, in);
weight-norm v (K, in, out) -> weight_v (out, in, K), g -> (out, 1, 1);
HWIO conv kernels -> OIHW; the ArcFace ``output_linear`` columns from
fvt_tpu's NHWC flatten to PyTorch's NCHW flatten.

Every value is carried as float32, which is what flax keeps under
``--amp`` too: bfloat16 there is a compute type and no parameter type,
so a ``VisualBackbone(dtype=torch.bfloat16)`` or an
``LFAN(backbone_dtype=torch.bfloat16)`` loads the same state_dict, and
the bridge carries nothing new for it.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence

import numpy as np
import torch

from fvt_tpu_torch.models.arcface import get_blocks_50

DEAD_KEY_PATTERNS = (r'^temporal\.[^.]+\.network\.\d+\.net\.[04]\.',
                     r'^spatial\.visual\.logits\.')


def is_dead_key(key: str) -> bool:
    """True for a key of the upstream model that no forward reads."""
    return any(re.match(p, key) for p in DEAD_KEY_PATTERNS)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(tree: dict, prefix: str, out: dict) -> None:
    d = tree['dense']
    out[f'{prefix}.weight'] = _t(np.asarray(d['kernel']).T)
    out[f'{prefix}.bias'] = _t(d['bias'])


def _bn(params: dict, stats: dict, prefix: str, out: dict) -> None:
    out[f'{prefix}.weight'] = _t(params['scale'])
    out[f'{prefix}.bias'] = _t(params['bias'])
    out[f'{prefix}.running_mean'] = _t(stats['mean'])
    out[f'{prefix}.running_var'] = _t(stats['var'])
    out[f'{prefix}.num_batches_tracked'] = torch.tensor(0, dtype=torch.int64)


def _wn_conv1d(tree: dict, prefix: str, out: dict) -> None:
    out[f'{prefix}.weight_v'] = _t(np.asarray(tree['v']).transpose(2, 1, 0))
    out[f'{prefix}.weight_g'] = _t(np.asarray(tree['g']).reshape(-1, 1, 1))
    out[f'{prefix}.bias'] = _t(tree['bias'])


def tcn_state_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """state_dict of the port's TemporalConvNet from a flax
    TemporalConvNet param tree (``block<i>`` subtrees)."""
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f'block{i}' in tree:
        blk = tree[f'block{i}']
        base = f'network.{i}'
        _wn_conv1d(blk['conv1'], f'{base}.conv1', out)
        _wn_conv1d(blk['conv2'], f'{base}.conv2', out)
        if 'downsample' in blk:
            d = blk['downsample']['proj']['dense']
            out[f'{base}.downsample.weight'] = _t(
                np.asarray(d['kernel']).T[:, :, None])
            out[f'{base}.downsample.bias'] = _t(d['bias'])
        i += 1
    return out


def fusion_state_from_flax(tree: dict, modality: Sequence[str]
                           ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's MultimodalTransformerEncoder from a flax
    one's param tree."""
    out: Dict[str, torch.Tensor] = {}
    attn = tree['self_attn']
    for m in modality:
        _linear(attn[f'qkv_{m}'], f'layers.self_attn.qkv_proj.{m}', out)
    _linear(attn['o_proj'], 'layers.self_attn.o_proj', out)
    out['layers.norm1.weight'] = _t(tree['norm1']['scale'])
    out['layers.norm1.bias'] = _t(tree['norm1']['bias'])
    return out


def _conv2d(tree: dict, prefix: str, out: dict) -> None:
    out[f'{prefix}.weight'] = _t(np.asarray(tree['kernel'])
                                 .transpose(3, 2, 0, 1))


def _bottleneck(blk: dict, bst: dict, base: str, out: dict) -> None:
    if 'shortcut_conv' in blk:
        _conv2d(blk['shortcut_conv'], f'{base}shortcut_layer.0', out)
        _bn(blk['shortcut_bn'], bst['shortcut_bn'],
            f'{base}shortcut_layer.1', out)
    _bn(blk['bn1'], bst['bn1'], f'{base}res_layer.0', out)
    _conv2d(blk['conv1'], f'{base}res_layer.1', out)
    out[f'{base}res_layer.2.weight'] = _t(blk['prelu']['alpha'])
    _conv2d(blk['conv2'], f'{base}res_layer.3', out)
    _bn(blk['bn2'], bst['bn2'], f'{base}res_layer.4', out)


def bottleneck_state_from_flax(params: dict, stats: dict
                               ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's ``BottleneckIR`` from one flax
    ``BottleneckIR``'s params and batch_stats (``bn1, conv1, prelu, conv2,
    bn2`` and, where the widths differ, ``shortcut_conv, shortcut_bn``)."""
    out: Dict[str, torch.Tensor] = {}
    _bottleneck(params, stats, '', out)
    return out


def conv3x3_kernel_from_flax(kernel) -> torch.Tensor:
    """A flax 3x3 conv kernel as the port's conv kernels take it: HWIO
    ``(3, 3, Cin, Cout)``, float32, contiguous (``fvt_tpu`` keeps HWIO
    too; ``Conv3x3.weight`` is its OIHW permutation)."""
    return _t(kernel).contiguous()


def fused_block_args_from_flax(params: dict, stats: dict) -> tuple:
    """``(w1, w2, a1, b1, alpha, a2, b2)`` for
    ``ops.bottleneck.bottleneck_ir_fused`` from one flax identity
    ``BottleneckIR``'s params and batch_stats: HWIO kernels and the two
    eval BatchNorms folded to affines."""
    from fvt_tpu_torch.ops.bottleneck import bn_affine

    def affine(name):
        return bn_affine(_t(params[name]['scale']), _t(params[name]['bias']),
                         _t(stats[name]['mean']), _t(stats[name]['var']))

    return (conv3x3_kernel_from_flax(params['conv1']['kernel']),
            conv3x3_kernel_from_flax(params['conv2']['kernel']),
            *affine('bn1'), _t(params['prelu']['alpha']), *affine('bn2'))


def _arcface(params: dict, stats: dict, prefix: str, out: dict) -> None:
    _conv2d(params['input_conv'], f'{prefix}.input_layer.0', out)
    _bn(params['input_bn'], stats['input_bn'], f'{prefix}.input_layer.1',
        out)
    out[f'{prefix}.input_layer.2.weight'] = _t(
        params['input_prelu']['alpha'])
    for i in range(len(get_blocks_50())):
        _bottleneck(params[f'body{i}'], stats[f'body{i}'],
                    f'{prefix}.body.{i}.', out)
    _bn(params['output_bn2d'], stats['output_bn2d'],
        f'{prefix}.output_layer.0', out)
    # fvt_tpu flattens NHWC (h*2560 + w*512 + c); PyTorch flattens NCHW
    w = np.asarray(params['output_linear']['kernel']).T  # (512, 5*5*512)
    w = w.reshape(512, 5, 5, 512).transpose(0, 3, 1, 2).reshape(512, -1)
    out[f'{prefix}.output_layer.3.weight'] = _t(w)
    out[f'{prefix}.output_layer.3.bias'] = _t(
        params['output_linear']['bias'])
    _bn(params['output_bn1d'], stats['output_bn1d'],
        f'{prefix}.output_layer.4', out)


def visual_backbone_state_from_flax(params: dict, batch_stats: dict
                                    ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's ``VisualBackbone`` from an ``fvt_tpu``
    ``VisualBackbone``'s variables (trees rooted at ``backbone``)."""
    out: Dict[str, torch.Tensor] = {}
    _arcface(params['backbone'], batch_stats['backbone'], 'backbone', out)
    return out


def lfan_state_from_flax(params: dict, batch_stats: dict,
                         modality: Sequence[str]) -> Dict[str, torch.Tensor]:
    """state_dict of the port's LFAN from an ``fvt_tpu`` LFAN's variables.
    ``modality`` is the model's modality order (leader first)."""
    if 'spatial_audio' in params:
        raise NotImplementedError('the VGGish (logmel) encoder is not '
                                  'ported yet')
    out: Dict[str, torch.Tensor] = {}
    for m in modality:
        for k, v in tcn_state_from_flax(params[f'temporal_{m}']).items():
            out[f'temporal.{m}.{k}'] = v
        _bn(params[f'bn_{m}']['bn'], batch_stats[f'bn_{m}']['bn'],
            f'bn.{m}', out)
    for k, v in fusion_state_from_flax(params['fusion'], modality).items():
        out[f'fusion.{k}'] = v
    _linear(params['regressor'], 'regressor', out)
    if 'spatial_video' in params:
        _arcface(params['spatial_video']['backbone'],
                 batch_stats['spatial_video']['backbone'],
                 'spatial.visual.backbone', out)
    return out
