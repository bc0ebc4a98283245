"""Converts checkpoints between upstream's PyTorch models and ``fvt_tpu``'s
msgpack, both directions, without flax: the port's counterpart of
``tools/port_checkpoint.py``, over the port's own weight bridge
(``models/to_jax.py``, ``models/from_jax.py``) and msgpack writer
(``models/checkpoint.py``).

upstream -> ``fvt_tpu`` (msgpack)::

    python -m fvt_tpu_torch.tools.port_checkpoint --model_name LFAN \\
        --modality vggish+bert --in model.pt --out model.msgpack
    python -m fvt_tpu_torch.tools.port_checkpoint --backbone arcface \\
        --in res50_ir_0.887.pth --out arcface.msgpack
    python -m fvt_tpu_torch.tools.port_checkpoint --backbone vggish \\
        --in vggish.pth --out vggish.msgpack

``fvt_tpu`` -> upstream (``--reverse``; the keys of upstream's model
classes, which load it with ``strict=True``, the dead ones included)::

    python -m fvt_tpu_torch.tools.port_checkpoint --reverse \\
        --model_name LFAN --modality vggish+bert \\
        --in best-models/FRAMES_VOTE/model.msgpack --out model.pt

The msgpack is the bytes ``tools/port_checkpoint.py`` writes from the same
``model.pt``: flax packs a dict in its insertion order, and that tool
builds its trees in the order of upstream's modules
(``fvt_tpu/models/torch_port.py``), which :func:`upstream_order` gives the
port's sorted trees.  The reverse writes what ``fvt_tpu``'s
``torch_export.export_state_dict`` writes: the state_dict of the port's
model plus upstream's dead keys (each weight-norm conv again under its
``net.0`` / ``net.4`` name, and zeros for CAN's ``conv_c``, MT's
``reduce_feats_dim`` and the ArcFace's ``logits``).  It runs on the host.
"""
from __future__ import annotations

import argparse
import re
from typing import Dict, Mapping, Sequence

import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.models.checkpoint import msgpack_dumps, msgpack_restore
from fvt_tpu_torch.models.from_jax import is_dead_key, state_from_flax
from fvt_tpu_torch.models.to_jax import (arcface_flax_from_state,
                                         flax_from_state,
                                         vggish_flax_from_state)

# the order of the keys of one dict of upstream's trees, by the names a
# dict holds (a name absent from a dict is skipped); numbered names
# (block<i>, layer<i>, body<i>, attn_<i>, conv<i>, fc<i>) go by number
_ORDERS = (
    ('kernel', 'bias'), ('v', 'g', 'bias'), ('scale', 'bias'),
    ('mean', 'var'), ('alpha',),
    ('in_proj_kernel', 'in_proj_bias', 'out_proj'),
    ('conv1', 'conv2', 'downsample'),
    ('attention', 'ff1', 'ff2', 'layer_norm1', 'layer_norm2'),
    ('self_attn', 'norm1'),
    ('augment_audio', 'visual_encoder', 'audio_encoder', 'CA_va', 'CA_av',
     'final_encoder', 'final_self_attention', 'reduce_feats', 'jr_encoder',
     'CA_jrv', 'CA_vjr', 'CA_jra', 'CA_ajr'),
    ('input_conv', 'input_bn', 'input_prelu', 'body#', 'output_bn2d',
     'output_linear', 'output_bn1d'),
    ('shortcut_conv', 'shortcut_bn', 'bn1', 'conv1', 'prelu', 'conv2',
     'bn2'),
    ('attn_#', 'weights'), ('conv#', 'fc#'), ('block#',), ('layer#',),
)
_NUMBERED = re.compile(r'^(.*?)(\d+)$')


def _rank(keys, order: Sequence[str]):
    """The sort key of ``keys`` under ``order``, or None where ``order``
    does not cover them."""
    def rank(k):
        if k in order:
            return (order.index(k), 0)
        m = _NUMBERED.match(k)
        if m and f'{m.group(1)}#' in order:
            return (order.index(f'{m.group(1)}#'), int(m.group(2)))
        return None
    ranks = {k: rank(k) for k in keys}
    return None if None in ranks.values() else ranks


def _ordered(tree, modality: Sequence[str]):
    if not isinstance(tree, dict):
        return tree
    keys = list(tree)
    if len(keys) > 1 and (any(k.startswith(('temporal_', 'bn_')) for k in keys) or \
            any(k.startswith('qkv_') for k in keys)):
        # a model's root (each modality's TCN then its BatchNorm, then the
        # family's fusion and head, then the backbones), or LFAN's
        # attention (each modality's qkv, then o_proj)
        def rank(k):
            for j, pre in enumerate(('temporal_', 'bn_', 'qkv_')):
                if k.startswith(pre) and k[len(pre):] in modality:
                    return (0, modality.index(k[len(pre):]), j)
            tail = ('fusion', 'regressor', 'fuse', 'fc1', 'bn1', 'fc2',
                    'o_proj', 'spatial_video', 'spatial_audio')
            return (1, tail.index(k), 0)
        keys.sort(key=rank)
    elif len(keys) > 1:
        for order in _ORDERS:
            ranks = _rank(keys, order)
            if ranks is not None:
                keys.sort(key=ranks.__getitem__)
                break
        else:
            raise KeyError(f'{keys}: no upstream order for these keys')
    return {k: _ordered(tree[k], modality) for k in keys}


def upstream_order(tree: dict, modality: Sequence[str] = ()) -> dict:
    """``tree`` (a params or batch_stats tree of ``to_jax``, keyed in
    sorted order) with every dict keyed in the order
    ``fvt_tpu/models/torch_port.py`` builds it from upstream's
    state_dict."""
    return _ordered(tree, list(modality))


def _legacy_weight_norm(sd: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """PyTorch >= 2.1's ``parametrizations.weight.original0/1`` under the
    legacy ``weight_g`` / ``weight_v`` names."""
    out = {}
    for k, v in sd.items():
        k = k.replace('.parametrizations.weight.original0', '.weight_g')
        out[k.replace('.parametrizations.weight.original1', '.weight_v')] = v
    return out


def family_msgpack(sd: Mapping[str, torch.Tensor], model_name: str,
                   modality: Sequence[str]) -> bytes:
    """``fvt_tpu``'s ``model.msgpack`` of upstream's ``model_name``
    state_dict ``sd`` (an embedded ArcFace or VGGish included)."""
    modality = [m for m in modality if 'continuous_label' not in m]
    state = {k: v for k, v in _legacy_weight_norm(sd).items()
             if not is_dead_key(k, model_name)}
    params, stats = flax_from_state(state, modality)
    return msgpack_dumps({'params': upstream_order(params, modality),
                          'batch_stats': upstream_order(stats, modality)})


def backbone_msgpack(sd: Mapping[str, torch.Tensor], backbone: str) -> bytes:
    """``fvt_tpu``'s msgpack of an upstream ArcFace (``res50_ir_*.pth``,
    keys rooted at ``backbone.``) or VGGish (``vggish.pth``) state_dict."""
    if backbone == 'arcface':
        p, s = arcface_flax_from_state(sd, 'backbone')
        params, stats = {'backbone': p}, {'backbone': s}
    elif backbone == 'vggish':
        params = vggish_flax_from_state({f'vggish.{k}': v
                                         for k, v in sd.items()}, 'vggish')
        stats = {}
    else:
        raise ValueError(f'--backbone {backbone}: arcface or vggish')
    return msgpack_dumps({'params': upstream_order(params),
                          'batch_stats': upstream_order(stats)})


def upstream_state_dict(tree: dict, model_name: str,
                        modality: Sequence[str]
                        ) -> Dict[str, torch.Tensor]:
    """Upstream's state_dict of ``model_name`` from ``fvt_tpu``'s
    ``{'params', 'batch_stats'}``: the port's, plus the dead keys."""
    modality = [m for m in modality if 'continuous_label' not in m]
    state = state_from_flax(tree['params'], tree.get('batch_stats', {}),
                            modality)
    out = dict(state)
    for k, v in state.items():
        m = re.match(r'^(temporal\.[^.]+\.network\.\d+)\.conv([12])\.(.*)$',
                     k)
        if m:  # legacy weight norm: the convs again in net's Sequential
            out[f'{m.group(1)}.net.{0 if m.group(2) == "1" else 4}.'
                f'{m.group(3)}'] = v.clone()
    zeros = {}
    if model_name == constants.CAN:
        zeros['conv_c'] = ((128, 128 * len(modality), 1), (128,))
    if model_name == constants.MT:
        zeros['fuse.reduce_feats_dim'] = ((128, 256), (128,))
    if any(k.startswith('spatial.visual.') for k in state):
        zeros['spatial.visual.logits'] = ((8, 512), (8,))
    for name, (w, b) in zeros.items():
        out[f'{name}.weight'] = torch.zeros(w)
        out[f'{name}.bias'] = torch.zeros(b)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--in', dest='inp', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--model_name', default=None,
                   choices=list(constants.FUSION_METHODS))
    p.add_argument('--modality', default='vggish+bert')
    p.add_argument('--backbone', default=None, choices=['arcface', 'vggish'])
    p.add_argument('--reverse', action='store_true',
                   help="fvt_tpu's msgpack -> upstream's model.pt")
    args = p.parse_args(argv)
    modality = args.modality.split('+')

    if args.reverse:
        if not args.model_name:
            p.error('--reverse needs --model_name')
        with open(args.inp, 'rb') as f:
            tree = msgpack_restore(f.read())
        sd = upstream_state_dict(tree, args.model_name, modality)
        torch.save(sd, args.out)
        print(f'exported {args.inp} -> {args.out} ({len(sd)} keys)')
        return

    sd = torch.load(args.inp, map_location='cpu')
    if args.backbone:
        blob = backbone_msgpack(sd, args.backbone)
    elif args.model_name:
        blob = family_msgpack(sd, args.model_name, modality)
    else:
        p.error('need --model_name or --backbone')
    with open(args.out, 'wb') as f:
        f.write(blob)
    print(f'ported {args.inp} -> {args.out}')


if __name__ == '__main__':
    main()
