"""An ``int8_static`` serving artifact that ``fvt_tpu`` exported, served by
the port on the CPU.

``fvt_tpu``'s ``export_serving`` writes a ``video+vggish`` LFAN
(numpy-filled weights, StableHLO for the CPU) with an ``act_scales``
collection in ``extra_vars`` (``fvt_tpu/export.py:209-218``); here the 41
amaxes come from the port's calibration of the same weights on the served
window (``fvt_tpu``'s own calibration is the same function,
``tests/test_torch_arcface_int8.py`` holds them equal block by block;
running it here would cost a second compile of the emulated int8 IR-50).
The port loads the artifact with its run's config, serving static int8
with the 41 amaxes equal to the written ones, and serves the window of 4
frames within 2e-2 of the largest logit of ``fvt_tpu``'s
``ServingArtifact.call`` (measured 4.9e-3): a float difference of ~1e-7
between the frameworks moves a value across a quantisation step now and
then, and the next int8 conv carries it (the drift the IR-50 test
states).  That gate is as wide as int8's distance from float, so the
served logits are also held bit for bit to the port's dynamic int8 on
the calibration batch, and apart from its float32 ones.  ``fvt_tpu``'s
export and call run once, in a module fixture.
"""
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from fvt_tpu import export as jax_export
from fvt_tpu.config.defaults import get_config as jax_get_config
from fvt_tpu.experiment import Experiment as JaxExperiment
from fvt_tpu.models.registry import init_model as jax_init_model
from fvt_tpu_torch import export
from fvt_tpu_torch.models.from_jax import state_from_flax
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.models.to_jax import act_scales_to_flax
from fvt_tpu_torch.serve import calibrate_act_scales, serving_forward

WINDOW, HOP = 4, 2
MODALITY = 'video+vggish+EXPR_continuous_label'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ('var', 'scale', 'g'):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ('kernel', 'v'):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == 'alpha':
            a = np.full(shape, 0.25)
        else:
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope='module')
def jax_int8_static(tmp_path_factory):
    cfg = jax_get_config('MELD')
    cfg.update(model_name='LFAN', modality=MODALITY, window_length=WINDOW,
               hop_length=HOP, eval_window_batch=1,
               serve_quant='int8_static')
    args = SimpleNamespace(**cfg)
    spatial_video, _ = JaxExperiment(args)._spatial_modules()
    model = jax_init_model(args, spatial_video=spatial_video)
    specs = jax_export.serving_input_specs(args, 1, WINDOW)
    inputs = {k: np.zeros(s.shape, np.float32) if k != 'video'
              else np.zeros(s.shape[:2] + (40, 40, 3), np.float32)
              for k, s in specs.items()}
    shapes = jax.eval_shape(lambda k: model.init(k, inputs, train=False),
                            jax.random.key(0))
    variables = _fill(shapes, 2)
    params, stats = variables['params'], variables['batch_stats']
    rng = np.random.default_rng(3)
    batch = {k: (rng.integers(0, 256, s.shape, np.uint8)
                 if s.dtype == np.uint8
                 else rng.standard_normal(s.shape).astype(np.float32))
             for k, s in specs.items()}
    port = init_model(args)
    port.load_state_dict(state_from_flax(params, stats, port.modality))
    calibrate_act_scales(port, batch, 'cpu')
    extra = {'act_scales': act_scales_to_flax(port)}
    exports, aot, meta = jax_export.export_serving(
        model, 'LFAN', args, params, stats, shapes=[(1, WINDOW)],
        platforms=['cpu'], extra_vars=extra)
    path = str(tmp_path_factory.mktemp('int8') / 'jax.fvtserve')
    jax_export.save_artifact(path, exports, aot, meta, params, stats,
                             extra_vars=extra)
    want = np.asarray(jax_export.load_artifact(path).call(batch))
    return path, args, extra['act_scales'], batch, want


def test_fvt_tpu_int8_static_artifact_loads_its_scales(jax_int8_static):
    path, args, scales, _, _ = jax_int8_static
    art = export.load_artifact(path, device='cpu', config=args)
    assert art.meta['flags']['serve_quant'] == 'int8_static'
    visual = art.model.spatial.visual
    assert visual.int8_mode() == 'static'
    got = dict(_leaves(visual.act_scales()))
    want = dict(_leaves(scales['spatial_video']))
    assert len(got) == 41 and set(got) == set(want)
    for k, v in want.items():
        assert got[k] == v, k


def test_fvt_tpu_int8_static_artifact_served_by_the_port(jax_int8_static):
    path, args, _, batch, want = jax_int8_static
    art = export.load_artifact(path, device='cpu', config=args)
    got = art.call(batch)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    # the gate above cannot tell int8 from float (the port's float32
    # convs give 3.0e-3 of the largest logit); the artifact's scales were
    # calibrated on this batch, so its static int8 equals the port's
    # dynamic int8 bit for bit, and float32 is 3.7e-3 away from it
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    served = {}
    for mode in ('int8', 'none'):
        model = init_model(SimpleNamespace(**{**vars(args),
                                              'serve_quant': mode}))
        model.load_state_dict(art.model.state_dict())
        served[mode] = serving_forward(model.eval(), inputs).numpy()
    np.testing.assert_array_equal(got, served['int8'])
    assert np.abs(served['none'] - got).max() > 1e-3 * np.abs(got).max()
