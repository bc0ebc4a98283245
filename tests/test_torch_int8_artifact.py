"""``int8_static`` serving artifacts of the port read by ``fvt_tpu``, on
the CPU: the calibrated ``act_scales`` ride in ``weights.msgpack`` as
``extra_vars`` (``fvt_tpu/export.py:209-218``).  The port's
``tools/export_serving.py`` of an ``int8_static`` run calibrates on
``--calib_store`` and writes ``weights.msgpack`` byte for byte as
``fvt_tpu``'s ``save_artifact`` writes the same weights and scales;
``fvt_tpu`` reads the 41 amaxes back equal; the port loads the artifact
serving static int8 with those amaxes, its logits the exporting model's
bit for bit.  (The other way: ``tests/test_torch_int8_fvt_artifact.py``.)
"""
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from flax import serialization as fser

from fvt_tpu import export as jax_export
from fvt_tpu_torch import constants, export
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config, to_namespace
from fvt_tpu_torch.models.checkpoint import save_best_model
from fvt_tpu_torch.models.registry import init_model
from fvt_tpu_torch.models.to_jax import act_scales_to_flax, flax_from_state
from fvt_tpu_torch.serve import ServingModel
from fvt_tpu_torch.tools import export_serving
from fvt_tpu_torch.tools.synth_store import make_cexpr_store

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


def test_port_int8_static_artifact_round_trips_through_fvt_tpu(tmp_path):
    store = make_cexpr_store(str(tmp_path / 'store'), [4, 6], seed=0)
    cfg = get_config(constants.MELD)
    cfg.update(model_name='LFAN', modality=MODALITY, window_length=WINDOW,
               hop_length=HOP, eval_window_batch=1, train_batch_size=1,
               eval_bucket_quantum=WINDOW, serve_quant='int8_static',
               dataset_name=constants.C_EXPR_DB_CHALLENGE, verbose=False)
    model = init_model(to_namespace(cfg))
    run = tmp_path / 'run'
    os.makedirs(run / 'best-models' / 'case')
    flat_yaml.dump(cfg, str(run / 'config.yml'))
    save_best_model(model, str(run / 'best-models' / 'case' /
                               'model.msgpack'), model.modality)
    line = export_serving.main(
        ['--fd_exp', str(run), '--calib_store', store['dataset_path'],
         '--calib_folds_dir', store['folds_dir']], device='cpu')
    with zipfile.ZipFile(line['artifact']) as z:
        got = z.read('weights.msgpack')
        meta = z.read('meta.json')
    art = export.load_artifact(line['artifact'], device='cpu')
    assert art.model.spatial.visual.int8_mode() == 'static'
    extra = {'act_scales': act_scales_to_flax(art.model)}
    params, stats = flax_from_state(art.model.state_dict(),
                                    art.model.modality)
    jax_export.save_artifact(str(tmp_path / 'jax.fvtserve'), {}, {},
                             json.loads(meta), params, stats,
                             extra_vars=extra)
    with zipfile.ZipFile(tmp_path / 'jax.fvtserve') as z:
        assert z.read('weights.msgpack') == got
    restored = fser.msgpack_restore(got)
    scales = dict(_leaves(restored['extra_vars']['act_scales']))
    assert len(scales) == 41
    want = dict(_leaves(extra['act_scales']))
    assert set(scales) == set(want)
    for k, v in scales.items():
        assert v.dtype == np.float32 and v.shape == () and v == want[k]

    # the exporting model, calibrated the same way, serves the same bits
    model.spatial.visual.load_act_scales(
        restored['extra_vars']['act_scales']['spatial_video'])
    spec = art.meta['shapes'][f'b1xt{WINDOW}']['inputs']
    rng = np.random.default_rng(1)
    batch = {k: (rng.integers(0, 256, v['shape'], np.uint8)
                 if v['dtype'] == 'uint8'
                 else rng.standard_normal(v['shape']).astype(np.float32))
             for k, v in spec.items()}
    plain = ServingModel(model, 1, WINDOW, HOP, 'cpu')
    np.testing.assert_array_equal(art.call(batch), plain.call(batch))
