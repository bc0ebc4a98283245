"""bfloat16 feature inputs (``--h2d_bf16_features``) served without
``ml_dtypes``, on the CPU.

* ``utils/bf16.bf16_bits``, the host rounding that ``Trainer.inference``,
  ``ServingModel.call``, ``streaming`` and ``tools/infer_artifact.py``
  share, equals ``ml_dtypes``' ``astype(bfloat16)`` bit for bit: ties to
  even, every NaN (a quiet NaN of its sign), +-inf, overflow to inf,
  subnormals, -0; ``as_bits`` takes raw bits and ``ml_dtypes`` arrays as
  they are, and the server core conforms a float32 chunk to those bits.
* An ``h2d_bf16_features`` LFAN that ``fvt_tpu`` exported (StableHLO for
  the CPU, numpy-filled weights) is served by the port, in process on
  float32, raw-bit and ``ml_dtypes`` inputs and over ``serve_http`` on
  float32 ones, within 1e-5 (relative to the largest logit) of
  ``fvt_tpu``'s ``ServingArtifact.call`` on its ``ml_dtypes`` inputs.
* The port's own export of such a run declares bfloat16 specs, as
  ``fvt_tpu``'s, and serves the same logits as the float32 model on the
  rounded values.
"""
import json
import os
import threading
import zipfile
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import jax
import pytest
import torch

from fvt_tpu import export as jax_export
from fvt_tpu.config.defaults import get_config as jax_get_config
from fvt_tpu.models.registry import init_model as jax_init_model
from fvt_tpu_torch import export, streaming
from fvt_tpu_torch.client import ServingClient
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config, to_namespace
from fvt_tpu_torch.models.checkpoint import save_best_model
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.serve import ServingModel
from fvt_tpu_torch.tools import export_serving, serve_http
from fvt_tpu_torch.utils import bf16

WINDOW, HOP, WB = 8, 4, 2


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ml(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).view(
        np.uint16)


def test_rounding_is_ml_dtypes_bit_for_bit():
    special = np.array([0x7fc00000, 0xffc00000, 0x7f800001, 0xff800001,
                        0x7fa00000, 0x7fffffff, 0xffffffff, 0x7f800000,
                        0xff800000, 0x7f7fffff, 0xff7fffff, 0x7f7f8000,
                        0x00000001, 0x80000001, 0x00008000, 0x00018000,
                        0x007fffff, 0x80000000, 0x00000000, 0x3f808000,
                        0x3f818000, 0x3f808001, 0x3f817fff],
                       np.uint32).view(np.float32)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64)
    random = bits.astype(np.uint32).view(np.float32)
    for x in (special, random, rng.standard_normal(10_000)
              .astype(np.float32) * 1e3):
        with np.errstate(invalid='ignore', over='ignore'):
            want = _ml(x)
        np.testing.assert_array_equal(bf16.bf16_bits(x), want)


def test_as_bits_and_the_server_core():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    want = _ml(x)
    np.testing.assert_array_equal(bf16.as_bits(x), want)
    assert bf16.as_bits(want) is want  # raw bits pass as they are
    np.testing.assert_array_equal(
        bf16.as_bits(x.astype(ml_dtypes.bfloat16)), want)
    np.testing.assert_array_equal(streaming._conform(x, 'bfloat16'), want)
    assert bf16.numpy_dtype('bfloat16') == np.uint16
    t = bf16.to_device(want, 'cpu')
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(
        ml_dtypes.bfloat16).astype(np.float32))


def _jax_args():
    cfg = jax_get_config('MELD')
    cfg.update(model_name='LFAN',
               modality='vggish+bert+EXPR_continuous_label',
               window_length=WINDOW, hop_length=HOP, eval_window_batch=WB,
               h2d_bf16_features=True)
    return SimpleNamespace(**cfg)


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ('var', 'scale', 'g'):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ('kernel', 'v'):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.fixture(scope='module')
def jax_artifact(tmp_path_factory):
    args = _jax_args()
    model = jax_init_model(args)
    specs = jax_export.serving_input_specs(args, WB, WINDOW)
    # the model itself takes float32: the serving step widens bfloat16
    inputs = {k: np.zeros(s.shape, np.float32) for k, s in specs.items()}
    shapes = jax.eval_shape(lambda k: model.init(k, inputs, train=False),
                            jax.random.key(0))
    variables = _fill(shapes, 2)
    exports, aot, meta = jax_export.export_serving(
        model, 'LFAN', args, variables['params'], variables['batch_stats'],
        shapes=[(WB, WINDOW)], platforms=['cpu'])
    path = str(tmp_path_factory.mktemp('bf16') / 'jax.fvtserve')
    jax_export.save_artifact(path, exports, aot, meta, variables['params'],
                             variables['batch_stats'])
    rng = np.random.default_rng(3)
    batch = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in specs.items()}
    want = np.asarray(jax_export.load_artifact(path).call(
        {k: v.astype(ml_dtypes.bfloat16) for k, v in batch.items()}))
    return path, args, batch, want


def test_fvt_tpu_bf16_feature_artifact_served_in_process(jax_artifact):
    path, args, batch, want = jax_artifact
    art = export.load_artifact(path, device='cpu', config=args)
    spec = art.meta['shapes']['b2xt8']['inputs']
    assert {v['dtype'] for v in spec.values()} == {'bfloat16'}
    _close(art.call(batch), want)
    _close(art.call({k: _ml(v) for k, v in batch.items()}), want)
    _close(art.call({k: v.astype(ml_dtypes.bfloat16)
                     for k, v in batch.items()}), want)
    with pytest.raises(ValueError, match='expected bfloat16'):
        art.call({k: v.astype(np.float64) for k, v in batch.items()})


def test_fvt_tpu_bf16_feature_artifact_served_over_http(tmp_path,
                                                        jax_artifact):
    path, args, batch, want = jax_artifact
    run = tmp_path / 'run'
    run.mkdir()
    flat_yaml.dump(vars(args), str(run / 'config.yml'))
    srv = serve_http.build_server(path, '127.0.0.1', 0, device='cpu',
                                  config=export.load_run_config(str(run)))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(f'http://127.0.0.1:{srv.server_port}')
        _close(client.logits(batch), want)
    finally:
        serve_http.drain_and_shutdown(srv, timeout_s=5)
        thread.join(timeout=10)


def test_port_export_of_a_bf16_feature_run(tmp_path):
    cfg = get_config('MELD')
    cfg.update(model_name='LFAN', modality='vggish+bert+EXPR_continuous_label',
               window_length=WINDOW, hop_length=HOP, eval_window_batch=WB,
               h2d_bf16_features=True, verbose=False)
    model = init_model(to_namespace(cfg))
    run = tmp_path / 'run'
    os.makedirs(run / 'best-models' / 'case')
    flat_yaml.dump(cfg, str(run / 'config.yml'))
    save_best_model(model, str(run / 'best-models' / 'case' /
                               'model.msgpack'), model.modality)
    line = export_serving.main(['--fd_exp', str(run)])
    with zipfile.ZipFile(line['artifact']) as z:
        meta = json.loads(z.read('meta.json'))
    jax_meta = jax_export.serving_input_specs(_jax_args(), WB, WINDOW)
    assert {k: v['dtype'] for k, v in meta['shapes']['b2xt8']['inputs']
            .items()} == {k: str(s.dtype) for k, s in jax_meta.items()}
    art = export.load_artifact(line['artifact'], device='cpu')
    rng = np.random.default_rng(4)
    batch = {k: rng.standard_normal((WB, WINDOW) + s.shape[2:])
             .astype(np.float32) for k, s in jax_meta.items()}
    rounded = {k: v.astype(ml_dtypes.bfloat16).astype(np.float32)
               for k, v in batch.items()}
    plain = ServingModel(model, WB, WINDOW, HOP, 'cpu')
    np.testing.assert_array_equal(art.call(batch), plain.call(rounded))
