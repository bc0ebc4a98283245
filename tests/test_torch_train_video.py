"""Tri-modal training in the port against fvt_tpu's, on the CPU: the
train video transform and the train-mode backbone's pieces.  The train
step itself and the ArcFace subtree's best-model bytes are in
``tests/test_torch_train_video_step.py``.

(i) The train video transform: ``fvt_tpu``'s ``train_video_transform``
with a key, and the port's with the crop offsets and flips that key
draws (re-derived here with ``jax.random``): equal bit for bit at 48^2,
within 1e-5 through the resize from 64^2.

(ii) The train-mode backbone's pieces on flax's: a narrow
``BottleneckIR`` (stride 1 and 2, with and without the shortcut conv),
and the input stem and the output layer at IR-50's real widths (built
here from ``fvt_tpu.models.layers`` pieces, dropout 0), each for two
steps with ``mutable=['batch_stats']``, in float32 and bfloat16: outputs
and running statistics.  float32: rtol 1e-5 / atol 1e-5 for outputs,
rtol 1e-5 / atol 1e-6 for the statistics.  bfloat16: the statistics as
in float32 (they are float32 sums of the same bfloat16 values); the
outputs of the block and the stem within 2^-7 of their magnitude plus
2^-9 (one unit in the last place; the BatchNorm rounds where flax's
does, so a flip comes only where a float32 sum rounds to the other side)
and equal bit for bit in at least 99% of elements; the head's float32
embeddings within 1e-4.
"""
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.data.transforms import train_video_transform as flax_transform
from fvt_tpu.models.arcface import ArcFaceBackbone
from fvt_tpu.models.arcface import BottleneckIR as FlaxBottleneckIR
from fvt_tpu.models.layers import PReLU as FlaxPReLU
from fvt_tpu.models.layers import TorchEMABatchNorm
from fvt_tpu_torch.data.transforms import (draw_crop_flip,
                                           train_video_transform)
from fvt_tpu_torch.models.arcface import BottleneckIR, VisualBackbone
from fvt_tpu_torch.models.from_jax import (bottleneck_state_from_flax,
                                           visual_backbone_state_from_flax)
from test_torch_config_store import flax_variables

BF16 = torch.bfloat16
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -9


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite's six workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _offsets(key, b):
    """The crop offsets and flips ``fvt_tpu``'s ``train_video_transform``
    draws from ``key`` (``transforms.py:64-68``), as torch tensors."""
    k1, k2, k3 = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.randint(k1, (b,), 0, 9), jax.random.randint(k2, (b,), 0, 9),
        jax.random.bernoulli(k3, 0.5, (b,))))


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().numpy()


def _port_stats(module, prefix=''):
    """Copies of the running statistics under ``prefix`` (``state_dict``
    hands out the live buffers, which a train step writes in place)."""
    return {k: v.numpy().copy() for k, v in module.state_dict().items()
            if k.startswith(prefix) and 'running_' in k}


# --------------------------------------------------------------- (i)
@pytest.mark.parametrize('hw', [48, 64])
def test_train_transform_matches_fvt_tpu(hw):
    rng = np.random.default_rng(hw)
    video = rng.integers(0, 256, (5, 3, hw, hw, 3), dtype=np.uint8)
    key = jax.random.key(hw)
    want = np.asarray(flax_transform(jnp.asarray(video, jnp.float32), key))
    offs_h, offs_w, flip = _offsets(key, 5)
    assert 0 < int(flip.sum()) < 5  # both branches taken
    got = train_video_transform(torch.from_numpy(video), offs_h, offs_w,
                                flip).numpy()
    assert got.shape == want.shape == (5, 3, 40, 40, 3)
    if hw == 48:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_draw_crop_flip_ranges_and_stream():
    a = draw_crop_flip(4096, torch.Generator().manual_seed(3))
    b = draw_crop_flip(4096, torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    offs_h, offs_w, flip = a
    for offs in (offs_h, offs_w):
        assert sorted(offs.unique().tolist()) == list(range(9))
    assert flip.dtype == torch.bool and 0.45 < flip.float().mean() < 0.55
    video = torch.randint(0, 256, (2, 3, 48, 48, 3), dtype=torch.uint8)
    out = train_video_transform(video, offs_h[:2], offs_w[:2], flip[:2])
    for i in range(2):  # one crop a window, shared by its frames
        crop = video[i, :, offs_h[i]:offs_h[i] + 40,
                     offs_w[i]:offs_w[i] + 40].float()
        crop = crop.flip(2) if flip[i] else crop
        assert torch.equal(out[i], (crop / 255.0 - 0.5) / 0.5)


# -------------------------------------------------------------- (ii)
def _two_steps(flax_module, variables, inputs, port_fn):
    """Two train-mode steps of ``flax_module`` (statistics carried) and of
    ``port_fn``; returns [(flax out, port out)] and flax's statistics."""
    stats = variables['batch_stats']
    outs = []
    for x in inputs:
        want, mutated = flax_module.apply(
            {'params': variables['params'], 'batch_stats': stats}, x,
            train=True, mutable=['batch_stats'])
        stats = mutated['batch_stats']
        with torch.no_grad():
            outs.append((np.asarray(want.astype(jnp.float32)),
                         port_fn(x)))
    return outs, _tree(stats)


def _check_bf16(got, want, exact_share):
    excess = np.abs(got - want) - BF16_RTOL * np.abs(want) - BF16_ATOL
    assert excess.max() <= 0, excess.max()
    assert (got == want).mean() >= exact_share, (got == want).mean()


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
@pytest.mark.parametrize('in_c,depth,stride', [(8, 8, 1), (8, 8, 2),
                                               (8, 16, 1), (8, 16, 2)])
def test_bottleneck_train_matches_flax(in_c, depth, stride, dtype):
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    flax_block = FlaxBottleneckIR(in_c, depth, stride, dtype=jdtype)
    rng = np.random.default_rng(in_c + depth + stride)
    xs = [rng.normal(size=(4, 6, 6, in_c)).astype(np.float32)
          for _ in range(2)]
    params, stats = flax_variables(flax_block, jnp.asarray(xs[0]), stride)
    block = BottleneckIR(in_c, depth, stride, dtype=dtype)
    block.load_state_dict(bottleneck_state_from_flax(params, stats),
                          strict=True)
    outs, want_stats = _two_steps(
        flax_block, {'params': params, 'batch_stats': stats},
        [jnp.asarray(x, jdtype) for x in xs],
        lambda x: _nhwc(block(_nchw(np.asarray(x.astype(jnp.float32)),
                                    dtype), train=True)))
    for want, got in outs:
        if dtype == BF16:
            _check_bf16(got, want, 0.99)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = bottleneck_state_from_flax(params, want_stats)
    got = _port_stats(block)
    assert len(got) == 2 * (3 if in_c != depth else 2)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert int(block.res_layer[0].num_batches_tracked) == 2


class _Stem(nn.Module):
    """``ArcFaceBackbone``'s input layer (``arcface.py:144-150``)."""
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x, *, train=False):
        x = x.astype(self.dtype)
        x = nn.Conv(64, (3, 3), strides=1, padding=1, use_bias=False,
                    dtype=self.dtype, name='input_conv')(x)
        x = TorchEMABatchNorm(use_running_average=not train, momentum=0.9,
                              epsilon=1e-5, dtype=self.dtype,
                              name='input_bn')(x)
        return FlaxPReLU(64, name='input_prelu')(x)


class _Head(nn.Module):
    """``ArcFaceBackbone``'s output layer (``arcface.py:157-166``) at
    dropout 0."""
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x, *, train=False):
        x = TorchEMABatchNorm(use_running_average=not train, momentum=0.9,
                              epsilon=1e-5, dtype=self.dtype,
                              name='output_bn2d')(x)
        x = nn.Dropout(0.0, deterministic=not train)(x)
        x = x.reshape(x.shape[0], -1).astype(jnp.float32)
        x = nn.Dense(512, name='output_linear')(x)
        x = TorchEMABatchNorm(use_running_average=not train, momentum=0.9,
                              epsilon=1e-5, name='output_bn1d')(x)
        return x / jnp.linalg.norm(x, ord=2, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _arcface_variables():
    """A filled flax ``VisualBackbone`` tree (no compile)."""
    class Visual(nn.Module):
        @nn.compact
        def __call__(self, x, *, train=False):
            return ArcFaceBackbone(name='backbone')(x, train=train)
    return flax_variables(Visual(), jnp.zeros((1, 40, 40, 3)), 5)


@pytest.mark.parametrize('dtype', [torch.float32, BF16])
@pytest.mark.parametrize('piece', ['stem', 'head'])
def test_stem_and_head_train_match_flax(piece, dtype):
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    params, stats = _arcface_variables()
    p, s = params['backbone'], stats['backbone']
    model = VisualBackbone(dtype=dtype)
    model.load_state_dict(visual_backbone_state_from_flax(params, stats),
                          strict=True)
    backbone = model.backbone
    backbone.output_layer[1].p = 0.0
    rng = np.random.default_rng(7)
    if piece == 'stem':
        names = ('input_conv', 'input_bn', 'input_prelu')
        xs = [rng.uniform(-1, 1, (4, 40, 40, 3)).astype(np.float32)
              for _ in range(2)]
        flax_piece, prefix = _Stem(dtype=jdtype), 'backbone.input_layer'

        def port(x):
            return _nhwc(backbone.stem(torch.from_numpy(np.asarray(x)),
                                       train=True))
        inputs = [jnp.asarray(x) for x in xs]
    else:
        names = ('output_bn2d', 'output_linear', 'output_bn1d')
        xs = [rng.normal(size=(4, 5, 5, 512)).astype(np.float32)
              for _ in range(2)]
        flax_piece, prefix = _Head(dtype=jdtype), 'backbone.output_layer'

        def port(x):
            return backbone.head(_nchw(np.asarray(x.astype(jnp.float32)),
                                       dtype), train=True).numpy()
        inputs = [jnp.asarray(x, jdtype) for x in xs]
    variables = {'params': {k: p[k] for k in names},
                 'batch_stats': {k: s[k] for k in names if k in s}}
    outs, want_stats = _two_steps(flax_piece, variables, inputs, port)
    for want, got in outs:
        if dtype == BF16 and piece == 'stem':
            _check_bf16(got, want, 0.99)
        elif dtype == BF16:
            # float32 from the Linear on: bfloat16's unit at the BatchNorm
            # becomes float32 noise through 12800 products
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = {'params': dict(params), 'batch_stats': dict(stats)}
    full['batch_stats']['backbone'] = {**s, **want_stats}
    want = visual_backbone_state_from_flax(full['params'],
                                           full['batch_stats'])
    got = _port_stats(model, prefix)
    assert len(got) == (2 if piece == 'stem' else 4)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_fused_blocks_refuse_train_mode():
    """The fused block folds the running statistics: a ``fused_blocks``
    backbone refuses the train forward, and trains under
    ``frozen_eval`` (the eval path) in an LFAN."""
    from fvt_tpu_torch.models.models import LFAN

    crops = torch.zeros(2, 40, 40, 3)
    with pytest.raises(ValueError, match='eval mode only'):
        VisualBackbone(fused_blocks=True)(
            crops, train=True, generator=torch.Generator())
    mods = ('video', 'vggish')
    tcn = {m: [8, 8, 4, 4] for m in mods}
    x = {'video': torch.zeros(1, 2, 40, 40, 3),
         'vggish': torch.zeros(1, 2, 128)}
    for frozen_eval in (False, True):
        model = LFAN(mods, 7, tcn_channel=tcn,
                     encoder_dim={m: 4 for m in mods}, fused_blocks=True,
                     frozen_eval=frozen_eval)
        if frozen_eval:
            out = model(x, True, torch.Generator())
            assert out.shape == (1, 2, 7) and torch.isfinite(out).all()
        else:
            with pytest.raises(ValueError, match='eval mode only'):
                model(x, True, torch.Generator())

