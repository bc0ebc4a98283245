"""The port's frozen serving artifact (``fvt_tpu_torch/export.py``,
``fvt_tpu_torch/tools/export_serving.py``) against ``fvt_tpu``'s, on the
CPU.

* ``weights.msgpack`` of the port's ``save_artifact`` is byte-equal to the
  one ``fvt_tpu.export.save_artifact`` writes for the same weights (LFAN,
  CAN; the ArcFace subtree's bytes are held in
  ``test_torch_train_video_step.py``);
* an artifact written by ``tools/export_serving.py`` from a run directory
  loads back bit for bit: the state_dict, ``meta.json``'s keys (JAX's
  null, ``torch_version``, ``model_args``) and the logits of the
  in-process ``ServingModel`` at each shape;
* artifacts that ``fvt_tpu`` exported on the CPU (StableHLO for ``cpu``)
  for a full-width ``vggish+bert`` LFAN and CAN, and an LFAN with
  ``num_heads`` 4 and one with ``task`` REGRESSION, on numpy-filled
  weights: refused without the run's config (no weight's shape fixes
  those fields), and with it served by the port within 1e-5 (relative to
  the largest logit) of ``fvt_tpu``'s ``ServingArtifact.call``, ignoring
  ``exports/``;
* a full-width JMT (``video+vggish``) artifact of the port with a length
  vector against ``fvt_tpu``'s ``make_eval_step(needs_time_mask=True)``
  on the same weights (the video as the port's ArcFace embeddings of the
  same crops: the backbone's parity is held elsewhere), without a length
  against the full length;
* the refusals: ``serve_quant`` and ``h2d_bf16_features`` flags that
  contradict the model or its specs (a bfloat16 spec in ``streaming`` is
  served as raw bits), a batch shape the artifact lacks, ``--mesh`` above
  the visible cards (server and artifact inference), ``--aot`` and
  ``--platforms cpu``, a length for an LFAN, a weight of the wrong
  shape.
"""
import json
import os
import zipfile
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from fvt_tpu import export as jax_export
from fvt_tpu.config.defaults import get_config as jax_get_config
from fvt_tpu.models.registry import init_model as jax_init_model
from fvt_tpu.train.steps import make_eval_step
from fvt_tpu_torch import export, streaming
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config, to_namespace
from fvt_tpu_torch.data.transforms import eval_video_transform
from fvt_tpu_torch.models.checkpoint import save_best_model
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.models.to_jax import flax_from_state
from fvt_tpu_torch.serve import ServingModel
from fvt_tpu_torch.tools import export_serving, infer_artifact, serve_http

WINDOW, HOP, WB = 8, 4, 2
RTOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Under the suite's six workers torch's spinning intra-op threads
    made small CPU runs tens of times slower: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, modality, **kw):
    cfg = get_config('MELD')
    cfg.update(model_name=name, modality=f'{modality}+EXPR_continuous_label',
               window_length=WINDOW, hop_length=HOP, eval_window_batch=WB,
               verbose=False, **kw)
    return cfg


def _model(cfg, seed=0):
    """The port's model of ``cfg`` with its BatchNorms' statistics drawn
    too (init leaves them at 0 and 1)."""
    model = init_model(to_namespace(cfg))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith('running_mean'):
                buf.copy_(torch.from_numpy(rng.normal(
                    0, 0.1, buf.shape).astype(np.float32)))
            elif name.endswith('running_var'):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, buf.shape).astype(np.float32)))
    return model


def _run_dir(root, cfg, model):
    run = os.path.join(root, cfg['model_name'])
    os.makedirs(os.path.join(run, 'best-models', 'case'))
    flat_yaml.dump(cfg, os.path.join(run, 'config.yml'))
    save_best_model(model, os.path.join(run, 'best-models', 'case',
                                        'model.msgpack'), model.modality)
    return run


def _batch(specs, seed=1):
    rng = np.random.default_rng(seed)
    return {k: (rng.integers(0, 256, v['shape'], dtype=np.uint8)
                if v['dtype'] == 'uint8'
                else rng.standard_normal(v['shape'], dtype=np.float32))
            for k, v in specs.items()}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def _read(path, name):
    with zipfile.ZipFile(path) as z:
        return z.read(name)


# ------------------------------------------------------ weights and round trip
@pytest.mark.parametrize('name,modality', [('LFAN', 'vggish+bert'),
                                           ('CAN', 'vggish+bert')])
def test_weights_msgpack_is_fvt_tpus_bytes(tmp_path, name, modality):
    cfg = _cfg(name, modality)
    model = _model(cfg)
    meta = export.build_meta(to_namespace(cfg), [(WB, WINDOW)])
    export.save_artifact(str(tmp_path / 'port.fvtserve'), meta, model)
    params, stats = flax_from_state(model.state_dict(), model.modality)
    jax_export.save_artifact(str(tmp_path / 'jax.fvtserve'), {}, {}, meta,
                             params, stats)
    got = _read(tmp_path / 'port.fvtserve', 'weights.msgpack')
    assert got == _read(tmp_path / 'jax.fvtserve', 'weights.msgpack')


def test_export_serving_round_trip(tmp_path):
    cfg = _cfg('LFAN', 'vggish+bert')
    model = _model(cfg)
    run = _run_dir(str(tmp_path), cfg, model)
    line = export_serving.main(['--fd_exp', run, '--window_batch', '2',
                                '--window_batch', '3', '--seq_len', '8'])
    assert line['shapes'] == ['b2xt8', 'b3xt8']
    assert line['platforms'] == ['cuda'] and line['aot'] == []
    art = export.load_artifact(line['artifact'], device='cpu')
    meta = json.loads(_read(line['artifact'], 'meta.json'))
    assert art.meta == meta
    assert meta['jax_version'] is None and meta['aot_backend'] is None
    assert meta['torch_version'] == torch.__version__
    assert meta['case_best_model'] == 'case'
    assert meta['model_args']['modal_dim'] == 32
    assert set(meta) >= {'format_version', 'model_name', 'modality',
                         'num_classes', 'needs_mask', 'platforms',
                         'window_length', 'hop_length', 'flags', 'shapes'}
    want_state = model.state_dict()
    got_state = art.model.state_dict()
    assert list(got_state) == list(want_state)
    for k, v in want_state.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(got_state[k], v), k
    server = ServingModel(model, None, WINDOW, HOP, 'cpu',
                          shapes=[(2, 8), (3, 8)])
    assert server.meta['shapes'] == meta['shapes']
    for key in art.shape_keys:
        batch = _batch(meta['shapes'][key]['inputs'])
        np.testing.assert_array_equal(art.call(batch), server.call(batch))


# ---------------------------------------------- fvt_tpu-exported artifacts
def _jax_args(name, modality):
    cfg = jax_get_config('MELD')
    cfg.update(model_name=name, modality=f'{modality}+EXPR_continuous_label',
               window_length=WINDOW, hop_length=HOP, eval_window_batch=WB)
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


@pytest.mark.parametrize('name,fields', [
    pytest.param('LFAN', {}, id='LFAN'),
    pytest.param('CAN', {}, id='CAN'),
    # fields that change no weight's shape: only the run's config has them
    pytest.param('LFAN', {'num_heads': 4}, id='LFAN-num_heads4'),
    pytest.param('LFAN', {'task': 'REGRESSION'}, id='LFAN-REGRESSION')])
def test_fvt_tpu_artifact_served_by_the_port(tmp_path, name, fields):
    args = _jax_args(name, 'vggish+bert')
    vars(args).update(fields)
    model = jax_init_model(args)
    specs = jax_export.serving_input_specs(args, WB, WINDOW)
    inputs = {k: np.zeros(s.shape, s.dtype) for k, s in specs.items()}
    shapes = jax.eval_shape(lambda k: model.init(k, inputs, train=False),
                            jax.random.key(0))
    variables = _fill(shapes, 2)
    params, stats = variables['params'], variables['batch_stats']
    exports, aot, meta = jax_export.export_serving(
        model, name, args, params, stats, shapes=[(WB, WINDOW)],
        platforms=['cpu'])
    path = str(tmp_path / 'jax.fvtserve')
    jax_export.save_artifact(path, exports, aot, meta, params, stats)

    with pytest.raises(ValueError, match='no model_args.*task, num_heads'):
        export.load_artifact(path, device='cpu')
    art = export.load_artifact(path, device='cpu', config=args)
    assert 'model_args' not in art.meta and art.shape_keys == ['b2xt8']
    batch = _batch(art.meta['shapes']['b2xt8']['inputs'])
    want = np.asarray(jax_export.load_artifact(path).call(batch))
    _close(art.call(batch), want)


def test_jmt_artifact_with_lengths_against_make_eval_step(tmp_path):
    cfg = _cfg('JMT', 'video+vggish')
    model = _model(cfg)
    path = str(tmp_path / 'jmt.fvtserve')
    export.save_artifact(path, export.build_meta(to_namespace(cfg),
                                                 [(WB, WINDOW)]), model)
    art = export.load_artifact(path, device='cpu')
    assert art.needs_mask and art.meta['needs_mask']
    batch = _batch(art.meta['shapes']['b2xt8']['inputs'])
    lengths = np.array([WINDOW, 5], np.int32)
    got = art.call(batch, length=lengths)
    full = art.call(batch)

    with torch.inference_mode():
        crops = eval_video_transform(torch.from_numpy(batch['video']))
        feats = art.model.encode_video({'video': crops}, False, None,
                                       False)['video'].numpy()
    jax_model = jax_init_model(_jax_args('JMT', 'video+vggish'))
    params, stats = flax_from_state(
        {k: v for k, v in model.state_dict().items()
         if not k.startswith('spatial.')}, model.modality)
    step = make_eval_step(jax_model, needs_time_mask=True)
    jax_in = {'video': feats, 'vggish': batch['vggish']}
    _close(got, np.asarray(step(params, stats, jax_in, lengths)))
    _close(full, np.asarray(step(params, stats, jax_in,
                                 np.full(WB, WINDOW, np.int32))))
    assert not np.array_equal(got[1], full[1])


# --------------------------------------------------------------- refusals
@pytest.fixture(scope='module')
def lfan_artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp('lfan')
    cfg = _cfg('LFAN', 'vggish+bert')
    model = _model(cfg)
    run = _run_dir(str(root), cfg, model)
    return run, export_serving.main(['--fd_exp', run])['artifact']


def _rewrite(path, out, meta_update=None, weights=None):
    meta = json.loads(_read(path, 'meta.json'))
    for k, v in (meta_update or {}).items():
        if isinstance(v, dict):
            meta[k].update(v)
        else:
            meta[k] = v
    with zipfile.ZipFile(out, 'w') as z:
        z.writestr('meta.json', json.dumps(meta))
        z.writestr('weights.msgpack',
                   weights or _read(path, 'weights.msgpack'))
    return out


@pytest.mark.parametrize('flags,what', [
    ({'serve_quant': 'int8'}, "flags.serve_quant='int8', but the model is "
                              "built with serve_quant='none'"),
    ({'h2d_bf16_features': True}, 'takes .*float32.*the model .*bfloat16')])
def test_unserved_flags_are_refused(tmp_path, lfan_artifact, flags, what):
    """int8 and bfloat16-feature serving are ported: the loader now
    refuses flags that contradict the artifact's model or its specs."""
    path = _rewrite(lfan_artifact[1], str(tmp_path / 'x.fvtserve'),
                    {'flags': flags})
    with pytest.raises(ValueError, match=what):
        export.load_artifact(path, device='cpu')


def test_bfloat16_spec_is_refused_by_the_server_core():
    """A bfloat16 spec is served: the server core conforms a chunk to
    bfloat16 bits (uint16), rounded as fvt_tpu's ml_dtypes cast; a dtype
    that numpy does not know is still refused."""
    got = streaming._conform(np.array([1.0, 1 + 2 ** -8, 3.0], np.float32),
                             'bfloat16')
    assert got.dtype == np.uint16
    assert got.tolist() == [0x3f80, 0x3f80, 0x4040]
    with pytest.raises(TypeError):
        streaming._conform(np.zeros(3, np.float32), 'float8')


def test_unknown_shape_and_length_for_lfan_are_refused(lfan_artifact):
    art = export.load_artifact(lfan_artifact[1], device='cpu')
    assert art.shape_keys == ['b2xt8']
    batch = _batch(art.meta['shapes']['b2xt8']['inputs'])
    with pytest.raises(KeyError, match=r"\(1, 8\).*b2xt8"):
        art.call({k: v[:1] for k, v in batch.items()})
    with pytest.raises(ValueError, match='no time mask'):
        art.call(batch, length=np.full(2, 4, np.int32))


def test_a_weight_of_the_wrong_shape_is_refused(tmp_path, lfan_artifact):
    path = _rewrite(lfan_artifact[1], str(tmp_path / 'x.fvtserve'),
                    {'model_args': {'modal_dim': 16}})
    with pytest.raises(RuntimeError, match='size mismatch'):
        export.load_artifact(path, device='cpu')


def test_mesh_aot_and_platforms_are_refused(lfan_artifact, monkeypatch):
    """``--mesh`` above the visible cards is refused, naming both counts,
    before anything is loaded (one card stubbed); AOT and other platforms
    are not served."""
    run, path = lfan_artifact
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='--mesh 2: need 2 devices, have 1'):
        serve_http.build_server(path, device='cuda', mesh_devices=2)
    with pytest.raises(ValueError, match='--mesh 2: need 2 devices, have 1'):
        infer_artifact.main(['--artifact', path, '--mesh', '2', '--mode',
                             'EVALUATION', '--fd_exp', run], device='cuda')
    with pytest.raises(export.NotServedError, match='--aot'):
        export_serving.main(['--fd_exp', run, '--aot'])
    with pytest.raises(export.NotServedError, match='--platforms cpu'):
        export_serving.main(['--fd_exp', run, '--platforms', 'cpu'])
