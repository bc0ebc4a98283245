"""One tri-modal LFAN train step of the port against fvt_tpu's, and the
ArcFace subtree of a best model, on the CPU.

(iii) One train step of a narrow tri-modal LFAN (the IR-50 at its fixed
depth, TCN widths 8, 8, 4, 4) at B = 2, T = 16 on uint8 48^2 video:
``fvt_tpu``'s ``train_step_body`` with a test-local flax wrapper
(``ArcFaceBackbone(drop_ratio=0.0, name='backbone')``, so the tree is
``VisualBackbone``'s) at TCN and fusion dropout 0, against the port's
``TrainStep.loss`` with the crop offsets that ``fvt_tpu``'s key draws
injected.  The JAX step is jitted: applied eagerly it took 31 s on a
CPU to compile op by op, jitted 6 s.  Its optimizer keeps the gradients it is
handed and moves nothing.  Each frame has its own colour under the
noise, so that the embeddings spread (frames of pure noise give a random
IR-50 nearly one embedding).  Held: the loss within 1e-5 relative;
every trainable gradient within 1e-4, or 1e-4 of its tensor's largest
value where that passes 1 (the train-mode embeddings agree to ~1e-5,
inside the float32 gate of the backbone's eval tests, rtol 2e-4 / atol
2e-5, and the video TCN's gradients carry that); the running statistics within rtol 1e-5 / atol 1e-6, the
backbone's 108 moved; under ``--frozen_eval_backbones`` the same, with
the backbone's statistics unmoved on both sides.

(iv) The ArcFace subtree through ``to_jax``: the trees equal
``fvt_tpu``'s bit for bit after a round trip through ``from_jax``, their
msgpack equal to ``flax.serialization.to_bytes``, and a best model
written and read back by the port bit for bit.
"""
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from fvt_tpu.models.arcface import ArcFaceBackbone
from fvt_tpu.models.models import LFAN as FlaxLFAN
from fvt_tpu.train.steps import TrainState, split_frozen, train_step_body
from fvt_tpu_torch.config.defaults import get_train_config
from fvt_tpu_torch.models.checkpoint import (load_best_model, msgpack_dumps,
                                             save_best_model)
from fvt_tpu_torch.models.from_jax import state_from_flax
from fvt_tpu_torch.models.models import LFAN
from fvt_tpu_torch.models.to_jax import flax_from_state
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train import steps as port_steps
from fvt_tpu_torch.train.steps import TrainStep, to_device
from test_torch_config_store import flax_variables
from test_torch_train_video import (_offsets, _port_stats, _tree,
                                    one_torch_thread)  # noqa: F401

MODS = ('video', 'vggish', 'bert')
TCN = {m: [8, 8, 4, 4] for m in MODS}
ENC = {m: c[-1] for m, c in TCN.items()}
B, T = 2, 16
LABEL = 'EXPR_continuous_label'
GRAD_TOL = 1e-4


# ------------------------------------------------------------- (iii)
class _Visual(nn.Module):
    """``VisualBackbone``'s tree with the backbone's dropout at 0."""

    @nn.compact
    def __call__(self, x, *, train=False):
        return ArcFaceBackbone(drop_ratio=0.0, name='backbone')(
            x, train=train)


def _flax_lfan(frozen_eval):
    return FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=TCN,
                    encoder_dim=ENC, tcn_dropout=0.0, fusion_dropout=0.0,
                    spatial_video=_Visual(), frozen_eval=frozen_eval)


@functools.lru_cache(maxsize=None)
def _variables():
    x = {'video': jnp.zeros((1, 4, 40, 40, 3)),
         'vggish': jnp.zeros((1, 4, 128)), 'bert': jnp.zeros((1, 4, 768))}
    return flax_variables(_flax_lfan(False), x, 3)


def _batch():
    rng = np.random.default_rng(17)
    # each frame its own colour under the noise (module docstring)
    video = np.clip(rng.integers(0, 256, (B, T, 1, 1, 3))
                    + rng.normal(0, 24, (B, T, 48, 48, 3)), 0, 255)
    return {'video': video.astype(np.uint8),
            'vggish': rng.normal(size=(B, T, 128)).astype(np.float32),
            'bert': rng.normal(size=(B, T, 768)).astype(np.float32),
            LABEL: rng.integers(0, 7, (B, T)).astype(np.int32)}


def _keep_gradients():
    """An optax transformation that moves nothing and keeps the gradients
    in its state: fvt_tpu's step hands them to ``optimizer.update``."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads
    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=None)
def _flax_step(frozen_eval):
    """fvt_tpu's train step: (loss, gradients of the trainable tree, the
    new batch_stats)."""
    params, stats = _variables()
    optimizer = _keep_gradients()
    trainable, _ = split_frozen(params)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=optimizer.init(trainable),
                       step=jnp.zeros((), jnp.int32))
    step = jax.jit(train_step_body(_flax_lfan(frozen_eval), optimizer))
    new, loss = step(state, {k: jnp.asarray(v) for k, v in _batch().items()},
                     jax.random.key(1))
    return float(loss), _tree(new.opt_state), _tree(new.batch_stats)


def _flax_crop_key():
    """The transform's key inside fvt_tpu's step 0 (``steps.py:123-131``)."""
    key = jax.random.fold_in(jax.random.key(1), 0)
    return jax.random.split(key)[0]


@pytest.mark.parametrize('frozen_eval', [False, True])
def test_tri_modal_train_step_matches_fvt_tpu(frozen_eval, monkeypatch):
    params, stats = _variables()
    want_loss, want_grads, want_stats = _flax_step(frozen_eval)
    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC, tcn_dropout=0.0,
                 fusion_dropout=0.0, frozen_eval=frozen_eval)
    model.spatial.visual.backbone.output_layer[1].p = 0.0
    model.load_state_dict(state_from_flax(params, stats, MODS),
                          strict=True)
    before = _port_stats(model, 'spatial.')
    offsets = _offsets(_flax_crop_key(), B)
    monkeypatch.setattr(port_steps, 'draw_crop_flip',
                        lambda b, g: offsets)
    step = TrainStep(model, optim.standardize_opt_params(get_train_config()),
                     'cpu')
    loss = step.loss(to_device(_batch(), step.device),
                     torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)

    want = state_from_flax(want_grads, stats, MODS)
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith('spatial.'):
            assert p.grad is None, name
            continue
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), (name, err)
        checked += 1
    assert checked == len(step.trainable)

    new = state_from_flax(params, want_stats, MODS)
    got = _port_stats(model)
    assert len(before) == 2 * 54
    for k, v in got.items():
        np.testing.assert_allclose(v, new[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        if k in before:
            assert np.array_equal(v, before[k]) == frozen_eval, k


# -------------------------------------------------------------- (iv)
def test_arcface_subtree_to_jax_bytes_and_round_trip(tmp_path):
    params, stats = _variables()
    state = state_from_flax(params, stats, MODS)
    back_params, back_stats = flax_from_state(state, MODS)
    for want, got in ((_tree(params), back_params),
                      (_tree(stats), back_stats)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(back_params) == sorted(back_params)
    assert list(back_params['spatial_video']['backbone']) == sorted(
        params['spatial_video']['backbone'])
    blob = msgpack_dumps({'params': back_params, 'batch_stats': back_stats})
    assert blob == serialization.to_bytes({'params': _tree(params),
                                           'batch_stats': _tree(stats)})

    model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC)
    model.load_state_dict(state, strict=True)
    path = str(tmp_path / 'model.msgpack')
    save_best_model(model, path, MODS)
    fresh = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC,
                 generator=torch.Generator().manual_seed(9))
    load_best_model(fresh, path, MODS)
    got = fresh.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
