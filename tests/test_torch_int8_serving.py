"""``--serve_quant int8 | int8_static`` through the port's CLIs on the CPU
(the plain versions of the int8 kernels), on tiny synthetic video stores.

* ``inference_challenge --serve_quant int8_static``: the ArcFace is
  calibrated after the weights load (a train-loader batch, the dynamic
  scale while recording), then every quantised conv of both eval paths,
  the bucketed forward of two short videos and the device-windowed stitch
  of a long one, takes the calibrated scales; its frames' argmax agrees
  with the float32 run's.
* Dynamic ``int8`` keeps ``fvt_tpu``'s call boundaries: a bucket of two
  whole videos (CAN) goes through the backbone in one call, though the
  eval chunk is smaller, and its logits differ from a chunked run's; a
  call that may not fit is refused with its frames and bytes.  So does
  the calibration: a batch larger than the eval chunk records the amaxes
  of one call over all its frames.
* ``config/parse.py`` keeps ``fvt_tpu``'s checks; an ``int8_static``
  export without a calibration store raises.
"""
import copy
import os
from os.path import join

import numpy as np
import pytest
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config, to_namespace
from fvt_tpu_torch.config.parse import parse_input
from fvt_tpu_torch.inference_challenge import main as challenge_main
from fvt_tpu_torch.models import arcface
from fvt_tpu_torch.models import models as models_mod
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.ops import quant
from fvt_tpu_torch.serve import calibrate_act_scales
from fvt_tpu_torch.tools import export_serving
from fvt_tpu_torch.tools.synth_store import make_cexpr_store
from fvt_tpu_torch.utils.io import load_pickle

DS = constants.C_EXPR_DB_CHALLENGE
WINDOW, HOP = 8, 4
MODALITY = 'video+vggish+bert'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """Two short videos (one bucket) and one of 14 frames (windowed)."""
    root = tmp_path_factory.mktemp('int8')
    return make_cexpr_store(str(root / 'store'), [4, 5, 14], seed=0)


def _run_dir(root, name='LFAN', **kw):
    run = join(root, f'run_{name}')
    best = join(run, 'best-models', 'case')
    os.makedirs(best)
    cfg = get_config(constants.MELD)
    cfg.update(model_name=name, modality=f'{MODALITY}+{constants.EXPR}',
               window_length=WINDOW, hop_length=HOP,
               eval_bucket_quantum=WINDOW, eval_window_batch=3,
               train_batch_size=1, outd=run, verbose=False)
    cfg.update(kw)
    flat_yaml.dump(cfg, join(run, 'config.yml'))
    torch.save(init_model(to_namespace(cfg)).state_dict(),
               join(best, 'model.pt'))
    return run


def _argv(run, store, outd, quant_mode):
    return ['--mode', 'EVALUATION', '--fd_exp', run, '--target_ds_name', DS,
            '--dataset_path', store['dataset_path'], '--folds_dir',
            store['folds_dir'], '--outd', outd, '--serve_quant', quant_mode]


class Spy:
    """Records each call of ``quant.quantize_int8``: (frames, static)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = quant.quantize_int8

        def spy(x, x_scale=None, prologue=None):
            self.calls.append((x.shape[0], x_scale is not None))
            return real(x, x_scale, prologue)

        monkeypatch.setattr(quant, 'quantize_int8', spy)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), float(np.asarray(v))


def _pred(outd):
    return load_pickle(join(outd, f'pred-{DS}', 'prediction.pkl'))


def test_int8_static_calibrates_and_reaches_both_eval_paths(
        tmp_path, store, monkeypatch):
    run = _run_dir(str(tmp_path))
    challenge_main(_argv(run, store, str(tmp_path / 'fp32'), 'none'),
                   device='cpu')
    spy = Spy(monkeypatch)
    exp = challenge_main(_argv(run, store, str(tmp_path / 'q'),
                               'int8_static'), device='cpu')
    visual = exp.trainer.model.spatial.visual
    assert visual.int8_mode() == 'static'
    assert len(visual.act_scales()['backbone']) == 21
    # the calibration forward: a train batch of one window, dynamic scale
    calib = [c for c in spy.calls if not c[1]]
    assert calib and set(calib) == {(WINDOW, False)}
    assert len(calib) == 41
    served = spy.calls[len(calib):]
    assert all(static for _, static in served)
    # the bucket (two short videos of 8 padded frames) and the 14-frame
    # video's three windows in one forward
    frames = {n for n, _ in served}
    assert frames == {2 * WINDOW, 3 * WINDOW}
    want, got = _pred(str(tmp_path / 'fp32')), _pred(str(tmp_path / 'q'))
    assert list(got) == list(want)
    agree = np.concatenate([got[v]['logits'].argmax(-1)
                            == want[v]['logits'].argmax(-1) for v in want])
    assert agree.mean() >= 0.9


def test_dynamic_int8_keeps_a_bucket_whole(tmp_path, store, monkeypatch):
    run = _run_dir(str(tmp_path), 'CAN', eval_video_batch=2,
                   eval_window_batch=1)
    calls = []
    real = models_mod.VisualBackbone.forward

    def record(self, x, *a, **k):
        calls.append(x.shape[0])
        return real(self, x, *a, **k)

    monkeypatch.setattr(models_mod.VisualBackbone, 'forward', record)
    exp = challenge_main(_argv(run, store, str(tmp_path / 'whole'), 'int8'),
                         device='cpu')
    assert exp.trainer.model.eval_frames == WINDOW
    # the two short videos' bucket in one call, the 14-frame video (a
    # bucket of its own, 16 padded frames) in another
    assert calls == [2 * WINDOW] * 2
    monkeypatch.setattr(models_mod.FusionModel, 'whole_calls',
                        property(lambda self: False))
    calls.clear()
    challenge_main(_argv(run, store, str(tmp_path / 'chunked'), 'int8'),
                   device='cpu')
    assert calls == [WINDOW] * 4
    whole = _pred(str(tmp_path / 'whole'))
    chunked = _pred(str(tmp_path / 'chunked'))
    assert any(not np.array_equal(whole[v]['logits'], chunked[v]['logits'])
               for v in whole)


def _int8_model(serve_quant):
    """A tri-modal LFAN whose eval chunk is one window of frames."""
    cfg = get_config(constants.MELD)
    cfg.update(modality=f'{MODALITY}+{constants.EXPR}', window_length=WINDOW,
               serve_quant=serve_quant, eval_window_batch=1)
    return init_model(to_namespace(cfg))


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    return {'video': rng.normal(size=(b, WINDOW, 40, 40, 3))
            .astype(np.float32),
            'vggish': rng.normal(size=(b, WINDOW, 128)).astype(np.float32),
            'bert': rng.normal(size=(b, WINDOW, 768)).astype(np.float32)}


def test_dynamic_int8_refuses_a_call_that_cannot_fit(monkeypatch):
    model = _int8_model('int8')
    assert model.whole_calls
    monkeypatch.setattr(arcface, 'free_device_bytes',
                        lambda device: 10 * (8 << 20))
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    with pytest.raises(MemoryError, match=r'16 frames.*134217728 bytes'):
        with torch.inference_mode():
            model(batch)


def test_calibration_keeps_a_batch_larger_than_the_eval_chunk_whole(
        monkeypatch):
    """A calibration batch of three windows, the eval chunk one window:
    the backbone records its amaxes over all 24 frames in one call, as
    fvt_tpu's one apply does, and they equal those of a model with no eval
    chunk; a chunked calibration records others (each conv's output takes
    its call's scale while recording)."""
    model = _int8_model('int8_static')
    assert model.eval_frames == WINDOW
    whole = copy.deepcopy(model)
    whole.eval_frames = None
    calls = []
    real = models_mod.VisualBackbone.forward

    def record(self, x, *a, **k):
        calls.append(x.shape[0])
        return real(self, x, *a, **k)

    monkeypatch.setattr(models_mod.VisualBackbone, 'forward', record)
    batch = _batch(3, seed=1)
    got = dict(_leaves(calibrate_act_scales(model, batch, 'cpu')))
    assert calls == [3 * WINDOW]
    want = dict(_leaves(calibrate_act_scales(whole, batch, 'cpu')))
    assert len(got) == 41 and got == want
    assert model.spatial.visual.int8_mode() == 'static'
    monkeypatch.setattr(models_mod.FusionModel, 'whole_calls',
                        property(lambda self: False))
    calls.clear()
    chunked = dict(_leaves(calibrate_act_scales(model, batch, 'cpu')))
    assert calls == [WINDOW] * 3
    assert chunked != want


def test_parse_keeps_fvt_tpus_checks(tmp_path, store):
    base = ['--dataset_name', DS, '--dataset_path', store['dataset_path'],
            '--folds_dir', store['folds_dir'], '--outd', str(tmp_path)]
    with pytest.raises(AssertionError, match='inference-only'):
        parse_input(base + ['--serve_quant', 'int8'])
    run = _run_dir(str(tmp_path))
    with pytest.raises(AssertionError,
                       match='int8_static is incompatible with '
                             '--pallas_serving'):
        parse_input(_argv(run, store, str(tmp_path / 'o'), 'int8_static')
                    + ['--pallas_serving', 'true'])


def test_int8_static_export_needs_a_calibration_store(tmp_path):
    run = _run_dir(str(tmp_path), serve_quant='int8_static',
                   dataset_path=str(tmp_path / 'absent'))
    with pytest.raises(SystemExit, match='needs a calibration store'):
        export_serving.main(['--fd_exp', run], device='cpu')
