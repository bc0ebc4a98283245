"""Frozen serving artifacts of the port (``fvt_tpu/export.py``): one zip
file, suggested suffix ``.fvtserve``, that a serving host loads with the
model code of this package and nothing of a training run.

    meta.json         fvt_tpu/export.py:189-205's keys, and model_args
    weights.msgpack   {'params', 'batch_stats'[, 'extra_vars']} in
                      fvt_tpu's byte format

``fvt_tpu`` also stores a StableHLO program per shape (``exports/``) and
optionally a compiled XLA executable (``aot/``).  Neither carries over to
PyTorch: the port builds the model again from ``meta['model_args']``, the
fields ``models.registry.init_model`` reads, loads the weights strictly
and serves the shapes of ``meta['shapes']``.  ``jax_version`` and
``aot_backend`` are null; ``torch_version`` stands beside them.
``weights.msgpack`` is ``to_jax.flax_from_state`` written by
``models.checkpoint.msgpack_dumps``: the bytes ``fvt_tpu``'s
``save_artifact`` writes for the same weights.  An ``int8_static``
artifact also holds ``extra_vars``, ``{'act_scales': ...}``: the
calibrated amaxes of the int8 ArcFace under ``fvt_tpu``'s paths
(``to_jax.act_scales_to_flax``), which the loader serves with
(``from_jax.load_act_scales``); ``flags.serve_quant`` must agree with the
model's and with their presence.  ``flags.h2d_bf16_features`` serves the
feature streams in bfloat16 (``serve.py``).

:func:`load_artifact` also reads an artifact that ``fvt_tpu`` exported: its
``meta.json`` and ``weights.msgpack``, ignoring ``exports/`` and
``aot/``.  Without ``model_args`` the model is built from the run's
config, which the caller passes (``config=``, ``--fd_exp``): no weight's
shape fixes ``task`` or ``num_heads``.
"""
from __future__ import annotations

import json
import os
import zipfile
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config
from fvt_tpu_torch.models.checkpoint import msgpack_dumps, msgpack_restore
from fvt_tpu_torch.models.from_jax import load_act_scales, state_from_flax
from fvt_tpu_torch.models.registry import init_model, split_modality
from fvt_tpu_torch.models.to_jax import flax_from_state, sorted_tree
from fvt_tpu_torch.parallel import serving
from fvt_tpu_torch.parallel.mesh import World, join
from fvt_tpu_torch.serve import ServingModel, serving_input_specs, shape_key
from fvt_tpu_torch.train.steps import resolve_device

FORMAT_VERSION = 1
# the platform the port serves on; fvt_tpu's are cpu and tpu
PLATFORM = 'cuda'
# what models.registry.init_model reads of a run's config
MODEL_ARGS = ('model_name', 'modality', 'task', 'num_classes',
              'dataset_name', 'use_other_class', 'tcn_kernel_size',
              'modal_dim', 'num_heads', 'amp', 'window_length',
              'eval_window_batch', 'frozen_eval_backbones', 'serve_quant',
              'seed')
FLAGS = ('amp', 'serve_quant', 'pallas_serving', 'h2d_bf16_features',
         'h2d_precrop_video')


class NotServedError(NotImplementedError):
    """An artifact or a request the port does not serve (ROADMAP.md A5)."""


def check_platforms(platforms: Sequence[str], aot: bool = False) -> list:
    """The platforms of a port export: the card's only, and no AOT
    executable."""
    if aot:
        raise NotServedError(
            '--aot: an XLA executable does not carry over to PyTorch; the '
            'port\'s artifact holds the weights and builds the model at load')
    platforms = list(platforms)
    if platforms != [PLATFORM]:
        raise NotServedError(
            f'--platforms {",".join(platforms)}: the port exports for '
            f'{PLATFORM!r} only (no StableHLO for cpu or tpu)')
    return platforms


def build_meta(args, shapes: Sequence[Tuple[int, int]],
               platforms: Sequence[str] = (PLATFORM,)) -> dict:
    """meta.json of an artifact of the model ``args`` (a run's config
    namespace) names, served at ``shapes``: ``fvt_tpu/export.py``'s keys,
    ``torch_version`` and ``model_args``."""
    flags = {k: getattr(args, k, None) for k in FLAGS}
    modality = split_modality(args.modality)
    precrop = getattr(args, 'h2d_precrop_video', True)
    num_classes = getattr(args, 'num_classes', None)
    return {
        'format_version': FORMAT_VERSION,
        'jax_version': None,
        'torch_version': torch.__version__,
        'model_name': args.model_name,
        'modality': args.modality,
        'num_classes': num_classes,
        'needs_mask': args.model_name in (constants.JMT, constants.MT),
        'platforms': list(platforms),
        'aot_backend': None,
        'window_length': getattr(args, 'window_length', None),
        'hop_length': getattr(args, 'hop_length', None),
        'flags': flags,
        'shapes': {shape_key(wb, t): {
            'window_batch': int(wb), 'seq_len': int(t),
            'inputs': serving_input_specs(
                modality, wb, t, precrop,
                bool(getattr(args, 'h2d_bf16_features', False)))}
            for wb, t in shapes},
        'model_args': {k: getattr(args, k) for k in MODEL_ARGS
                       if hasattr(args, k)},
    }


def save_artifact(path: str, meta: dict, model,
                  extra_vars: Optional[dict] = None) -> None:
    """Writes the artifact of ``model`` (the port's model or its
    state_dict) with ``meta`` at ``path``; ``extra_vars`` (``{'act_scales':
    ...}`` of an ``int8_static`` model) beside its weights, as ``fvt_tpu``
    stores them."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) \
        else model
    params, stats = flax_from_state(
        state, split_modality(meta['modality']))
    weights = {'batch_stats': stats, 'params': params}
    if extra_vars:
        weights['extra_vars'] = extra_vars
    weights = sorted_tree(weights)
    tmp = f'{path}.tmp'
    with zipfile.ZipFile(tmp, 'w', zipfile.ZIP_DEFLATED) as z:
        z.writestr('meta.json', json.dumps(meta, indent=2, default=str))
        # keys in sorted order, as flax's to_state_dict leaves them;
        # stored: random or trained float32 weights barely deflate, and
        # deflating hundreds of MB is most of a write
        z.writestr('weights.msgpack', msgpack_dumps(weights),
                   compress_type=zipfile.ZIP_STORED)
    os.replace(tmp, path)


def model_args(meta: dict, config=None) -> SimpleNamespace:
    """The config namespace the artifact's model is built from:
    ``config/defaults.py``'s values with ``meta['model_args']`` over them,
    or, for an artifact without them (``fvt_tpu``'s), the fields of
    ``MODEL_ARGS`` from ``config``, the run's config (a mapping or a
    namespace, e.g. its ``config.yml``).  Strict loading catches only the
    fields that change a weight's shape; ``task`` and ``num_heads`` do
    not, so such an artifact without ``config`` is refused."""
    cfg = get_config(constants.MELD)
    if 'model_args' in meta:
        cfg.update(meta['model_args'])
        return SimpleNamespace(**cfg)
    if config is None:
        raise ValueError(
            'the artifact has no model_args (fvt_tpu exported it): the '
            'fields no weight\'s shape fixes (task, num_heads, ...) cannot '
            'be known; pass the run\'s config (load_artifact(path, '
            'config=...), --fd_exp)')
    if not isinstance(config, dict):
        config = vars(config)
    cfg.update({k: config[k] for k in MODEL_ARGS if k in config})
    for k in ('model_name', 'modality'):
        if cfg[k] != meta[k]:
            raise ValueError(f'the run\'s config has {k}={cfg[k]!r}, the '
                             f'artifact {meta[k]!r}')
    return SimpleNamespace(**cfg)


class ServingArtifact(ServingModel):
    """A loaded ``.fvtserve``: the model built from its meta, its weights
    on ``device`` from load, one ``call`` routed by the batch's (B, T) to
    the artifact's shapes (:class:`~fvt_tpu_torch.serve.ServingModel`), or
    ``call_sharded`` over a serving group; ``meta`` is the file's."""

    def __init__(self, path: str, device=None, config=None):
        self.path = path
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read('meta.json'))
            weights = msgpack_restore(z.read('weights.msgpack'))
        params, stats = weights['params'], weights.get('batch_stats', {})
        args = model_args(meta, config)
        model = init_model(args)
        model.load_state_dict(state_from_flax(params, stats,
                                              model.modality), strict=True)
        flags = meta.get('flags') or {}
        load_extra_vars(model, weights.get('extra_vars'),
                        flags.get('serve_quant') or 'none',
                        getattr(args, 'serve_quant', 'none') or 'none')
        shapes = [(v['window_batch'], v['seq_len'])
                  for _, v in sorted(meta['shapes'].items())]
        # a config without the flag is served precropped, as in fvt_tpu
        precrop = flags.get('h2d_precrop_video') is not False
        super().__init__(model, None, meta['window_length'],
                         meta['hop_length'], resolve_device(device),
                         shapes=shapes, precrop_video=precrop,
                         bf16_features=bool(flags.get('h2d_bf16_features')))
        for key, spec in meta['shapes'].items():
            if spec['inputs'] != self.shape_specs[key]:
                raise ValueError(f'{path}: {key} takes {spec["inputs"]}, '
                                 f'the model {self.shape_specs[key]}')
        if bool(meta.get('needs_mask')) != self.needs_mask:
            raise ValueError(f'{path}: needs_mask {meta.get("needs_mask")} '
                             f'for a {meta["model_name"]}')
        self.meta = meta

    def call_sharded(self, batch: Dict[str, np.ndarray], mesh=None,
                     length: Optional[np.ndarray] = None) -> np.ndarray:
        """Data-parallel serving from the same artifact, ``fvt_tpu``'s
        ``call_sharded`` (``fvt_tpu/export.py:345-398``): the batch's rows
        split over the ranks of ``mesh``, the serving group's
        :class:`~fvt_tpu_torch.parallel.mesh.World` (None: the group this
        process is in), each holding the weights; this process is rank 0
        and every other rank follows (``parallel/serving.py``).  Routed by
        (B, T) as :meth:`call`; the world's size must divide B
        (AssertionError).  JMT's and MT's ``length`` is split with the
        rows and their final attention spans the call, as dynamic int8's
        scale does, so the result is the single call's up to float32
        summation order: (B, T, C) float32 numpy logits."""
        world = join(self.device) if mesh is None else mesh
        if world is None:
            raise RuntimeError(
                'call_sharded: this process is in no process group; start '
                'a serving group (parallel.serving.start) or join one '
                '(parallel.mesh.join) first')
        key, arrays, lengths = self.host_inputs(batch, length)
        b = len(next(iter(arrays.values())))
        if b % world.size:
            raise AssertionError(
                f"window_batch {b} must divide by the mesh's {world.size} "
                f"devices — export a divisible shape or pass a smaller mesh")
        with self._lock:
            return serving.lead(self, world, key, arrays, lengths)

    def stop_followers(self, mesh: World) -> None:
        """Ends the loop of every follower of ``mesh``, once no call is
        running."""
        with self._lock:
            serving.stop(mesh)


def load_extra_vars(model, extra_vars: Optional[dict], flag: str,
                    built: str) -> None:
    """Serves ``model`` with an artifact's ``extra_vars``: the
    ``act_scales`` of an ``int8_static`` artifact.  Raises where the
    artifact's ``flags.serve_quant`` (``flag``), the model it builds
    (``built``) and the presence of the scales disagree, or on another
    collection."""
    if flag != built:
        raise ValueError(f'flags.serve_quant={flag!r}, but the model is '
                         f'built with serve_quant={built!r}')
    extra = dict(extra_vars or {})
    scales = extra.pop('act_scales', None)
    if extra:
        raise NotServedError(f'extra_vars {sorted(extra)}: the port serves '
                             f'act_scales only')
    if (scales is not None) != (flag == 'int8_static'):
        raise ValueError(f'serve_quant={flag!r} with'
                         f'{"" if scales is not None else "out"} '
                         f'act_scales: int8_static artifacts, and they '
                         f'only, carry them')
    if scales is not None:
        load_act_scales(model, scales)


def load_artifact(path: str, device=None, config=None) -> ServingArtifact:
    """The artifact at ``path`` on ``device`` (None: the card);
    ``config``, the run's config, builds the model of an artifact without
    ``model_args`` (:func:`model_args`)."""
    return ServingArtifact(path, device, config)


def load_run_config(fd_exp: str) -> SimpleNamespace:
    """A training run's ``config.yml``."""
    return SimpleNamespace(**flat_yaml.load(os.path.join(fd_exp,
                                                         'config.yml')))
