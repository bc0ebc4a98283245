"""The backbone's eval forward is the call's, not the module's: a
``VisualBackbone`` never put in eval mode, one after ``.train()``, and an
``LFAN`` after ``.train()`` served with ``train=False`` give fvt_tpu's eval
output on the same weights and move no running statistic.

One module-scoped fixture initialises the flax ArcFace (IR-50 at its fixed
depth) and a narrow ``video+vggish`` LFAN, moves every BatchNorm and PReLU
off its init value (an identity BatchNorm would hide batch statistics)
and carries the weights into the port through ``from_jax``.  The JAX side
runs ``apply(..., train=False)``; the port runs on the CPU.  Tolerances
are those of ``test_arcface_matches_flax``: rtol 2e-4 / atol 2e-5 for the
embeddings, atol 1e-4 for logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.arcface import VisualBackbone as FlaxVisualBackbone
from fvt_tpu.models.models import LFAN as FlaxLFAN
from fvt_tpu_torch.models.arcface import VisualBackbone, arcface_forward_eval
from fvt_tpu_torch.models.from_jax import state_from_flax
from fvt_tpu_torch.models.models import LFAN
from test_torch_lfan_serving import _perturb

MODS = ('video', 'vggish')
TCN = {'video': [16, 16, 8, 8], 'vggish': [16, 16, 8, 8]}
ENC = {m: c[-1] for m, c in TCN.items()}
B, T, N = 1, 3, 2


@pytest.fixture(scope='module')
def flax_models():
    rng = np.random.default_rng(0)
    feat_model = FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=TCN,
                          encoder_dim=ENC)
    feats = {'video': jnp.zeros((1, 8, 512)), 'vggish': jnp.zeros((1, 8, 128))}
    lfan_vars = jax.jit(lambda r, x: feat_model.init(r, x, train=False))(
        jax.random.key(0), feats)
    arc_vars = jax.jit(lambda r, x: FlaxVisualBackbone().init(
        r, x, train=False))(jax.random.key(1), jnp.zeros((1, 40, 40, 3)))
    params = _perturb(dict(lfan_vars['params'],
                           spatial_video=arc_vars['params']), rng, stats=False)
    stats = _perturb(dict(lfan_vars['batch_stats'],
                          spatial_video=arc_vars['batch_stats']), rng,
                     stats=True)
    crops = rng.uniform(-1, 1, (N, 40, 40, 3)).astype(np.float32)
    embeddings = np.asarray(jax.jit(lambda v, x: FlaxVisualBackbone().apply(
        v, x, train=False))({'params': params['spatial_video'],
                             'batch_stats': stats['spatial_video']},
                            jnp.asarray(crops)))
    batch = {'video': rng.uniform(-1, 1, (B, T, 40, 40, 3)).astype(np.float32),
             'vggish': rng.normal(size=(B, T, 128)).astype(np.float32)}
    model = FlaxLFAN(modality=MODS, output_dim=7, tcn_channel=TCN,
                     encoder_dim=ENC, spatial_video=FlaxVisualBackbone())
    logits = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {'params': params, 'batch_stats': stats},
        {k: jnp.asarray(v) for k, v in batch.items()}))
    return {'state': state_from_flax(params, stats, MODS),
            'crops': crops, 'embeddings': embeddings, 'batch': batch,
            'logits': logits}


def _statistics(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.rsplit('.', 1)[-1] in ('running_mean', 'running_var',
                                        'num_batches_tracked')}


def _backbone(state):
    prefix = 'spatial.visual.'
    model = VisualBackbone()
    model.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                           if k.startswith(prefix)}, strict=True)
    return model


@pytest.mark.parametrize('case', ['never_eval', 'after_train',
                                  'forward_eval_after_train',
                                  'lfan_after_train'])
def test_eval_forward_ignores_the_training_flag(flax_models, case):
    if case == 'lfan_after_train':
        model = LFAN(MODS, 7, tcn_channel=TCN, encoder_dim=ENC)
        model.load_state_dict(flax_models['state'], strict=True)
        model.train()
        want, rtol, atol = flax_models['logits'], 0, 1e-4
    else:
        model = _backbone(flax_models['state'])
        if case != 'never_eval':
            model.eval().train()
        want, rtol, atol = flax_models['embeddings'], 2e-4, 2e-5
    assert model.training
    before = _statistics(model)
    # the backbone's 54 BatchNorms, and the LFAN's one a modality
    assert len(before) == 3 * (54 + (len(MODS) if case == 'lfan_after_train'
                                     else 0))
    with torch.no_grad():
        if case == 'lfan_after_train':
            got = model({k: torch.from_numpy(v)
                         for k, v in flax_models['batch'].items()},
                        train=False)
        elif case == 'forward_eval_after_train':
            got = arcface_forward_eval(
                model, torch.from_numpy(flax_models['crops']))
        else:
            got = model(torch.from_numpy(flax_models['crops']))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    for k, v in _statistics(model).items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('dims', [4, 2])
def test_batchnorm_eval_is_the_modules_eval_call_bit_for_bit(dtype, dims):
    """``batchnorm_eval`` gives the bits of ``bn.eval()(x)``, bfloat16
    activations with float32 statistics too, so the eval outputs of
    every path, phase 5's bfloat16 ones included, do not move."""
    from fvt_tpu_torch.models.arcface import batchnorm_eval

    rng = np.random.default_rng(dims)
    c = 24
    bn = (torch.nn.BatchNorm2d if dims == 4 else torch.nn.BatchNorm1d)(c)
    with torch.no_grad():
        for t, shift in ((bn.running_mean, 0.0), (bn.running_var, 1.0),
                         (bn.weight, 1.0), (bn.bias, 0.0)):
            t.copy_(torch.from_numpy(
                rng.normal(shift, 0.3, c).astype(np.float32)).abs_()
                if t is bn.running_var else torch.from_numpy(
                rng.normal(shift, 0.3, c).astype(np.float32)))
    shape = (5, c, 3, 3) if dims == 4 else (5, c)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    if dims == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    bn.train()
    with torch.no_grad():
        got = batchnorm_eval(bn, x)
        want = bn.eval()(x)
    assert got.dtype == dtype
    assert torch.equal(got, want)
