"""Weight bridge: ``fvt_tpu`` flax trees -> a state_dict of the port's
LFAN, CAN, JMT or MT.

:func:`state_from_flax` takes the flax ``params`` and ``batch_stats``
trees as nested dicts of numpy arrays and returns the state_dict that the
port's model loads with ``strict=True``.  Keys and values are those of
``fvt_tpu.models.torch_export`` (``lfan_to_torch``, ``can_to_torch``,
``jmt_to_torch``; legacy weight-norm naming), less the dead keys those
exporters make up for the upstream models: the TCN ``net.0`` / ``net.4``
duplicates, ``spatial.visual.logits``, CAN's ``conv_c`` and MT's
``fuse.reduce_feats_dim`` (JMT's is live).  So a reference ``model.pt``
loads as it is once its family's dead keys are dropped
(:func:`is_dead_key`).

:data:`LAYOUT` pairs each module of the port with its flax subtree and
its kind, which fixes the leaves and their layout conversions: Dense
kernel (in, out) -> Linear weight (out, in); weight-norm v (K, in, out)
-> weight_v (out, in, K), g -> (out, 1, 1); the 1x1 downsample's kernel
(in, out) -> (out, in, 1); ``nn.MultiheadAttention``'s ``in_proj_weight``
(3E, E) from ``in_proj_kernel`` (E, 3E); BatchNorm ``scale``/``bias`` and
``mean``/``var``; LayerNorm ``scale``/``bias``.  ``models/to_jax.py``
reads the same table the other way.  The ArcFace of a ``video`` model:
HWIO conv kernels -> OIHW, the ``output_linear`` columns from
fvt_tpu's NHWC flatten to PyTorch's NCHW flatten.  The VGGish of a
``logmel`` model (``spatial_audio``, parameters only): HWIO conv kernels
-> OIHW and Dense kernels transposed, nothing permuted, since the port's
VGGish flattens NHWC as ``fvt_tpu``'s does (``models/vggish.py``).

:func:`load_act_scales` takes an ``act_scales`` collection (the
``extra_vars`` of an ``int8_static`` artifact) into an int8 ArcFace.

:func:`retinaface_state_from_flax` and :func:`fan_state_from_flax` turn
``fvt_tpu``'s detector and landmark variables back into the published
files' upstream-named state dicts (``fvt_tpu``'s
``port_torch_state_dict`` the other way), which the port's
``preprocess.retinaface.RetinaFaceNet`` and ``preprocess.fan.FAN`` load as
they are.

Every value is carried as float32, which is what flax keeps under
``--amp`` too: bfloat16 there is a compute type and no parameter type,
so a model with ``backbone_dtype=torch.bfloat16`` loads the same
state_dict, and the bridge carries nothing new for it.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.models.arcface import get_blocks_50
from fvt_tpu_torch.models.vggish import feature_indices

# keys of the upstream models that no forward reads: of every family, and
# of one family only (JMT reads its reduce_feats_dim, MT does not)
DEAD_KEY_PATTERNS = (r'^temporal\.[^.]+\.network\.\d+\.net\.[04]\.',
                     r'^spatial\.visual\.logits\.')
FAMILY_DEAD_KEY_PATTERNS = {constants.CAN: (r'^conv_c\.',),
                            constants.MT: (r'^fuse\.reduce_feats_dim\.',)}


def is_dead_key(key: str, model_name: str = constants.LFAN) -> bool:
    """True for a key of the upstream ``model_name`` that no forward
    reads."""
    return any(re.match(p, key) for p in DEAD_KEY_PATTERNS
               + FAMILY_DEAD_KEY_PATTERNS.get(model_name, ()))


# (port module, fvt_tpu subtree, kind); {m} is a modality, {i} an index
LAYOUT = (
    ('temporal.{m}.network.{i}.{c}', 'temporal_{m}/block{i}/{c}', 'wn'),
    ('temporal.{m}.network.{i}.downsample',
     'temporal_{m}/block{i}/downsample/proj', 'linear1x1'),
    # TemporalConvNet(attention=1)'s attention blocks
    ('temporal.{m}.attn.{i}.{l}', 'temporal_{m}/attn{i}/{l}', 'linear'),
    ('bn.{m}', 'bn_{m}/bn', 'bn'),
    # LFAN
    ('fusion.layers.self_attn.qkv_proj.{m}', 'fusion/self_attn/qkv_{m}',
     'linear'),
    ('fusion.layers.self_attn.o_proj', 'fusion/self_attn/o_proj', 'linear'),
    ('fusion.layers.norm1', 'fusion/norm1', 'layernorm'),
    ('regressor', 'regressor', 'linear'),
    # CAN
    ('fuse.attn.{i}', 'fuse/attn_{i}', 'linear'),
    ('fuse.weights', 'fuse/weights', 'linear'),
    # JMT and MT
    ('fuse.augment_audio_feats_dim', 'fuse/augment_audio', 'linear'),
    ('fuse.reduce_feats_dim', 'fuse/reduce_feats', 'linear'),
    ('fuse.{e}.layers.{i}.attention', 'fuse/{e}/layer{i}/attention', 'mha'),
    ('fuse.{e}.layers.{i}.attention.out_proj',
     'fuse/{e}/layer{i}/attention/out_proj', 'linear'),
    ('fuse.{e}.layers.{i}.feed_forward.0', 'fuse/{e}/layer{i}/ff1',
     'linear'),
    ('fuse.{e}.layers.{i}.feed_forward.2', 'fuse/{e}/layer{i}/ff2',
     'linear'),
    ('fuse.{e}.layers.{i}.{n}', 'fuse/{e}/layer{i}/{n}', 'layernorm'),
    ('fuse.{a}', 'fuse/{a}', 'mha'),
    ('fuse.{a}.out_proj', 'fuse/{a}/out_proj', 'linear'),
    # CAN, JMT and MT
    ('{f}', '{f}', 'linear'),
    ('bn1', 'bn1/bn', 'bn'),
)
# the modules of models/fusion_extra.py on their own, keys from the
# module's root: the intra-modal stack's layers.<i> is flax's layer<i>;
# self_attn.{l} before self_attn.qkv_{m}, which would take qkv_proj too
MODULE_LAYOUT = (
    ('{l}', '{l}', 'linear'),
    ('self_attn.{l}', 'self_attn/{l}', 'linear'),
    ('self_attn.qkv_proj.{m}', 'self_attn/qkv_{m}', 'linear'),
    ('layers.{i}.self_attn.{l}', 'layer{i}/self_attn/{l}', 'linear'),
    ('layers.{i}.{l}', 'layer{i}/{l}', 'linear'),
    ('{o}', '{o}', 'layernorm'),
    ('layers.{i}.{o}', 'layer{i}/{o}', 'layernorm'),
)
_FIELDS = {'m': r'[A-Za-z0-9_]+', 'i': r'\d+', 'c': r'conv[12]',
           'e': r'[a-z]+_encoder', 'n': r'layer_norm[12]',
           'a': r'CA_[a-z]+|final_self_attention', 'f': r'fc[12]',
           'l': r'(?:key|query|value)_layer|qkv_proj|o_proj|ff[12]',
           'o': r'norm[12]'}


def _t_(a: np.ndarray) -> np.ndarray:
    return a.T


# a kind's leaves: (port leaf, flax collection, flax leaf path, layout
# conversion to flax, to the port)
_LEAVES = {
    'linear': (('weight', 'params', ('dense', 'kernel'), _t_, _t_),
               ('bias', 'params', ('dense', 'bias'), None, None)),
    'linear1x1': (('weight', 'params', ('dense', 'kernel'),
                   lambda w: w[:, :, 0].T, lambda k: k.T[:, :, None]),
                  ('bias', 'params', ('dense', 'bias'), None, None)),
    'wn': (('weight_v', 'params', ('v',), lambda v: v.transpose(2, 1, 0),
            lambda v: v.transpose(2, 1, 0)),
           ('weight_g', 'params', ('g',), lambda g: g.reshape(-1),
            lambda g: g.reshape(-1, 1, 1)),
           ('bias', 'params', ('bias',), None, None)),
    'bn': (('weight', 'params', ('scale',), None, None),
           ('bias', 'params', ('bias',), None, None),
           ('running_mean', 'batch_stats', ('mean',), None, None),
           ('running_var', 'batch_stats', ('var',), None, None)),
    'layernorm': (('weight', 'params', ('scale',), None, None),
                  ('bias', 'params', ('bias',), None, None)),
    'mha': (('in_proj_weight', 'params', ('in_proj_kernel',), _t_, _t_),
            ('in_proj_bias', 'params', ('in_proj_bias',), None, None)),
}
# the frozen backbones' flax subtrees, and where the VGGish's keys go
SPATIAL = ('spatial_video', 'spatial_audio')
AUDIO_PREFIX = 'spatial.audio.backbone'
# BatchNorm's step count, which flax keeps nowhere
NO_FLAX = 'num_batches_tracked'


def _pattern(template: str) -> str:
    return ''.join(re.escape(part) if k % 2 == 0
                   else f'(?P<{part}>{_FIELDS[part]})'
                   for k, part in enumerate(re.split(r'\{(\w)\}',
                                                     template)))


def _rules(side: int, layout: tuple = LAYOUT) -> Tuple[tuple, ...]:
    """(compiled module pattern of ``side`` (0 the port's, 1 fvt_tpu's),
    the other side's template, leaves) of every entry of ``layout``."""
    return tuple((re.compile(_pattern(entry[side])), entry[1 - side],
                  _LEAVES[entry[2]]) for entry in layout)


_PORT_RULES = _rules(0)
_FLAX_RULES = _rules(1)
MODULE_PORT_RULES = _rules(0, MODULE_LAYOUT)
_MODULE_FLAX_RULES = _rules(1, MODULE_LAYOUT)


def flax_place(key: str, rules: Tuple[tuple, ...] = _PORT_RULES
               ) -> Tuple[str, Tuple[str, ...], Callable]:
    """(collection, flax path, conversion or None) of a port key that
    LAYOUT (or the layout of ``rules``) maps, else KeyError."""
    module, _, leaf = key.rpartition('.')
    for pattern, template, leaves in rules:
        m = pattern.fullmatch(module)
        if m is None:
            continue
        for name, collection, path, to_flax, _ in leaves:
            if name == leaf:
                return (collection,
                        tuple(template.format(**m.groupdict()).split('/'))
                        + path, to_flax)
    raise KeyError(f'{key}: no counterpart in fvt_tpu\'s tree')


def _port_place(collection: str, path: Tuple[str, ...],
                rules: Tuple[tuple, ...] = _FLAX_RULES
                ) -> Tuple[str, Callable]:
    """(port key, conversion or None) of a flax leaf, else KeyError."""
    joined = '/'.join(path)
    for pattern, template, leaves in rules:
        for name, coll, leaf_path, _, to_port in leaves:
            n = len(leaf_path)
            if coll != collection or tuple(path[-n:]) != leaf_path:
                continue
            m = pattern.fullmatch('/'.join(path[:-n]))
            if m is not None:
                return (f'{template.format(**m.groupdict())}.{name}',
                        to_port)
    raise KeyError(f'{collection}/{joined}: no counterpart in the port')


def _leaves(tree: dict, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bn(params: dict, stats: dict, prefix: str, out: dict) -> None:
    out[f'{prefix}.weight'] = _t(params['scale'])
    out[f'{prefix}.bias'] = _t(params['bias'])
    out[f'{prefix}.running_mean'] = _t(stats['mean'])
    out[f'{prefix}.running_var'] = _t(stats['var'])
    out[f'{prefix}.num_batches_tracked'] = torch.tensor(0, dtype=torch.int64)


def tcn_state_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """state_dict of the port's TemporalConvNet from a flax
    TemporalConvNet param tree (``block<i>`` subtrees)."""
    return {k[len('temporal.m.'):]: v for k, v in
            state_from_flax({'temporal_m': tree}, {}).items()}


def module_state_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """state_dict of one of the port's ``models/fusion_extra.py`` modules
    from its flax counterpart's param tree (MODULE_LAYOUT)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        key, to_port = _port_place('params', path, _MODULE_FLAX_RULES)
        value = np.asarray(value)
        out[key] = _t(to_port(value) if to_port else value)
    return out


def fusion_state_from_flax(tree: dict, modality: Sequence[str]
                           ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's MultimodalTransformerEncoder over
    ``modality`` from a flax one's param tree."""
    found = {k[len('qkv_'):] for k in tree['self_attn']
             if k.startswith('qkv_')}
    if found != set(modality):
        raise ValueError(f'the tree projects {sorted(found)}, not '
                         f'{sorted(modality)}')
    return {k[len('fusion.'):]: v for k, v in
            state_from_flax({'fusion': tree}, {}).items()}


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


def _detector_bn(params: dict, stats: dict, prefix: str, out: dict) -> None:
    """A BatchNorm under the published detectors' keys: no
    ``num_batches_tracked`` (their files have none; PyTorch fills it)."""
    _bn(params, stats, prefix, out)
    del out[f'{prefix}.num_batches_tracked']


def retinaface_state_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """The upstream-named state_dict (``retinaface_resnet50_2020-07-20.pth``'s
    keys) of the port's ``preprocess.retinaface.RetinaFaceNet`` from
    ``fvt_tpu``'s RetinaFaceNet variables (``port_torch_state_dict`` the
    other way)."""
    params, stats = variables['params'], variables['batch_stats']
    out: Dict[str, torch.Tensor] = {}
    bp, bs = params['body'], stats['body']
    _conv2d(bp['conv1'], 'body.conv1', out)
    _detector_bn(bp['bn1'], bs['bn1'], 'body.bn1', out)
    for li, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            blk, bst = bp[f'layer{li + 1}_{b}'], bs[f'layer{li + 1}_{b}']
            base = f'body.layer{li + 1}.{b}'
            for ci in (1, 2, 3):
                _conv2d(blk[f'conv{ci}'], f'{base}.conv{ci}', out)
                _detector_bn(blk[f'bn{ci}'], bst[f'bn{ci}'],
                             f'{base}.bn{ci}', out)
            if 'down_conv' in blk:
                _conv2d(blk['down_conv'], f'{base}.downsample.0', out)
                _detector_bn(blk['down_bn'], bst['down_bn'],
                             f'{base}.downsample.1', out)
    convbns = [(f'fpn_{n}', f'fpn.{n}') for n in
               ('output1', 'output2', 'output3', 'merge1', 'merge2')]
    for i in (1, 2, 3):
        convbns += [((f'ssh{i}', sub), f'ssh{i}.{sub}') for sub in
                    ('conv3X3', 'conv5X5_1', 'conv5X5_2', 'conv7X7_2',
                     'conv7x7_3')]
    for path, prefix in convbns:
        p, st = params, stats
        for k in (path if isinstance(path, tuple) else (path,)):
            p, st = p[k], st[k]
        _conv2d(p['conv'], f'{prefix}.0', out)
        _detector_bn(p['bn'], st['bn'], f'{prefix}.1', out)
    for tname, fname in (('BboxHead', 'bbox_head'),
                         ('ClassHead', 'class_head'),
                         ('LandmarkHead', 'landmark_head')):
        for i in range(3):
            head = params[f'{fname}{i}']
            _conv2d(head, f'{tname}.{i}.conv1x1', out)
            out[f'{tname}.{i}.conv1x1.bias'] = _t(head['bias'])
    return out


def fan_state_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """The upstream-named state_dict (``2DFAN4``'s keys) of the port's
    ``preprocess.fan.FAN`` from ``fvt_tpu``'s FAN variables
    (``port_torch_state_dict`` the other way)."""
    params, stats = variables['params'], variables['batch_stats']
    out: Dict[str, torch.Tensor] = {}

    def conv(tree, prefix):
        _conv2d(tree, prefix, out)
        if 'bias' in tree:
            out[f'{prefix}.bias'] = _t(tree['bias'])

    def convblock(p, st, prefix):
        for i in (1, 2, 3):
            _detector_bn(p[f'bn{i}'], st[f'bn{i}'], f'{prefix}.bn{i}', out)
            conv(p[f'conv{i}'], f'{prefix}.conv{i}')
        if 'down_conv' in p:
            _detector_bn(p['down_bn'], st['down_bn'],
                         f'{prefix}.downsample.0', out)
            conv(p['down_conv'], f'{prefix}.downsample.2')

    conv(params['conv1'], 'conv1')
    _detector_bn(params['bn1'], stats['bn1'], 'bn1', out)
    for name in ('conv2', 'conv3', 'conv4'):
        convblock(params[name], stats[name], name)
    stacks = sum(1 for k in params if k.startswith('top_m_'))
    for i in range(stacks):
        for name, sub in params[f'm{i}'].items():
            convblock(sub, stats[f'm{i}'][name], f'm{i}.{name}')
        convblock(params[f'top_m_{i}'], stats[f'top_m_{i}'], f'top_m_{i}')
        conv(params[f'conv_last{i}'], f'conv_last{i}')
        _detector_bn(params[f'bn_end{i}'], stats[f'bn_end{i}'],
                     f'bn_end{i}', out)
        conv(params[f'l{i}'], f'l{i}')
        if f'bl{i}' in params:
            conv(params[f'bl{i}'], f'bl{i}')
            conv(params[f'al{i}'], f'al{i}')
    return out


# the VGGish's Linear layers: fvt_tpu's Dense fc<j> is embeddings.<i>
VGGISH_EMBEDDINGS = (0, 2, 4)


def vggish_state_from_flax(params: dict, prefix: str = ''
                           ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's ``VGGish`` from ``fvt_tpu``'s VGGish
    params (``conv0``-``conv5``, ``fc0``-``fc2``), keys under ``prefix``
    (``fvt_tpu``'s ``vggish_from_torch`` the other way)."""
    p = f'{prefix}.' if prefix else ''
    out: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate(feature_indices()):
        conv = params[f'conv{i}']
        _conv2d(conv, f'{p}features.{idx}', out)
        out[f'{p}features.{idx}.bias'] = _t(conv['bias'])
    for j, idx in enumerate(VGGISH_EMBEDDINGS):
        out[f'{p}embeddings.{idx}.weight'] = _t(
            np.asarray(params[f'fc{j}']['kernel']).T)
        out[f'{p}embeddings.{idx}.bias'] = _t(params[f'fc{j}']['bias'])
    if len(params) != len(out) // 2:
        raise KeyError(f'{sorted(params)}: not the VGGish\'s six convs and '
                       f'three Dense layers')
    return out


def visual_backbone_state_from_flax(params: dict, batch_stats: dict
                                    ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's ``VisualBackbone`` from an ``fvt_tpu``
    ``VisualBackbone``'s variables (trees rooted at ``backbone``)."""
    out: Dict[str, torch.Tensor] = {}
    _arcface(params['backbone'], batch_stats['backbone'], 'backbone', out)
    return out


def state_from_flax(params: dict, batch_stats: dict,
                    modality: Optional[Sequence[str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's model from an ``fvt_tpu`` LFAN's, CAN's,
    JMT's or MT's variables.  A ``video`` model's
    ``spatial_video/backbone`` goes to ``spatial.visual.backbone.*``, a
    ``logmel`` model's ``spatial_audio`` to ``spatial.audio.backbone.*``.
    Raises on a leaf it does not map, and where ``modality`` is given, on
    TCNs of other modalities."""
    found = {k[len('temporal_'):] for k in params
             if k.startswith('temporal_')}
    if modality is not None and found != set(modality):
        raise ValueError(f'the tree has the TCNs of {sorted(found)}, not of '
                         f'{sorted(modality)}')
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in (('params', params),
                             ('batch_stats', batch_stats)):
        for path, value in _leaves({k: v for k, v in tree.items()
                                    if k not in SPATIAL}):
            key, to_port = _port_place(collection, path)
            value = np.asarray(value)
            out[key] = _t(to_port(value) if to_port else value)
            if key.endswith('.running_mean'):
                out[key.replace('running_mean', NO_FLAX)] = torch.tensor(
                    0, dtype=torch.int64)
    if 'spatial_video' in params:
        _arcface(params['spatial_video']['backbone'],
                 batch_stats['spatial_video']['backbone'],
                 'spatial.visual.backbone', out)
    if 'spatial_audio' in params:
        out.update(vggish_state_from_flax(params['spatial_audio'],
                                          AUDIO_PREFIX))
    return out


def load_act_scales(model, act_scales: dict) -> None:
    """Serves ``model``'s int8 ArcFace with the amaxes of ``fvt_tpu``'s
    ``act_scales`` collection of the whole model (``{'spatial_video':
    <VisualBackbone's tree>}``, ``calibrate_act_scales``' result).  Raises
    on any other tree."""
    if set(act_scales) != {'spatial_video'}:
        raise KeyError(f'act_scales holds {sorted(act_scales)}: fvt_tpu '
                       f'quantises spatial_video only')
    model.spatial.visual.load_act_scales(act_scales['spatial_video'])
