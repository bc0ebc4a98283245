"""The port needs neither JAX, flax, PyYAML, msgpack, orbax, ml_dtypes nor
anything of fvt_tpu (its serving and training paths, a video model's
train step and its ArcFace in fvt_tpu's tree, a CAN's and an MT's train
step and their trees, every conv path of the ArcFace
backbone, its tools, the training CLI with checkpoints and resume
and the challenge inference CLI on stores of its own synthetic writer,
a logmel model with its VGGish and the regression trainer with a
ParamControl release run, a TemporalConvNet with attention=1, and a best
model exported as an artifact, served over HTTP through the client and
by artifact inference, the int8 backbone calibrated and its scales
carried, the bfloat16 host rounding, with all of them blocked), and
chip_smoke.py refuses to run without a CUDA card."""
import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX = textwrap.dedent('''
    import importlib.abc
    import sys

    BLOCKED = ('jax', 'jaxlib', 'flax', 'yaml', 'msgpack', 'orbax',
               'ml_dtypes', 'fvt_tpu')

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ModuleNotFoundError(f'{name} is blocked', name=name)
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch

    # the suite's workers share the cores: torch's spinning intra-op
    # threads would make this process many times slower there
    torch.set_num_threads(1)

    import fvt_tpu_torch
    import fvt_tpu_torch.kernels.build
    from fvt_tpu_torch.config.defaults import get_train_config
    from fvt_tpu_torch.models.from_jax import state_from_flax
    from fvt_tpu_torch.models.models import LFAN
    from fvt_tpu_torch.serve import ServingModel
    from fvt_tpu_torch.streaming import StreamingSession
    from fvt_tpu_torch.train.trainer import Trainer

    tcn = {'vggish': [8, 8, 4, 4], 'bert': [8, 8, 4, 4]}
    tcn_logmel = {'logmel': [8, 4], 'bert': [8, 4]}
    model = LFAN(('vggish', 'bert'), 7, tcn_channel=tcn,
                 encoder_dim={'vggish': 4, 'bert': 4},
                 generator=torch.Generator().manual_seed(0))
    sess = StreamingSession(ServingModel(model, 2, 6, 4, 'cpu'))
    rng = np.random.default_rng(0)
    frames = {'vggish': rng.normal(size=(9, 128)).astype(np.float32),
              'bert': rng.normal(size=(9, 768)).astype(np.float32)}
    first = sess.feed(frames)[1]
    rest = sess.close()[1]
    out = np.concatenate([first, rest])
    assert out.shape == (9, 7) and np.isfinite(out).all(), out.shape

    batch = {'vggish': rng.normal(size=(2, 6, 128)).astype(np.float32),
             'bert': rng.normal(size=(2, 6, 768)).astype(np.float32),
             'EXPR_continuous_label': rng.integers(0, 7, (2, 6))}
    loss = Trainer(model, get_train_config(), 'cpu').train_one_epoch(
        [batch], 0)
    assert np.isfinite(loss), loss

    # a video model trains (the train transform, the backbone in train
    # mode) and its ArcFace goes to fvt_tpu's tree
    from fvt_tpu_torch.models.to_jax import flax_from_state
    video_mods = ('video', 'vggish')
    video_model = LFAN(video_mods, 7, tcn_channel={m: [8, 8, 4, 4]
                                                   for m in video_mods},
                       encoder_dim={m: 4 for m in video_mods},
                       generator=torch.Generator().manual_seed(0))
    video_batch = {
        'video': rng.integers(0, 256, (1, 2, 48, 48, 3), dtype=np.uint8),
        'vggish': rng.normal(size=(1, 2, 128)).astype(np.float32),
        'EXPR_continuous_label': rng.integers(0, 7, (1, 2))}
    loss = Trainer(video_model, get_train_config(), 'cpu').train_one_epoch(
        [video_batch], 0)
    assert np.isfinite(loss), loss
    params, stats = flax_from_state(video_model.state_dict(), video_mods)
    assert 'backbone' in params['spatial_video'], list(params)
    assert 'backbone' in stats['spatial_video'], list(stats)

    # CAN, JMT and MT: built, trained a step and written in fvt_tpu's tree
    from fvt_tpu_torch.models.models import CAN, JMT
    narrow = {m: {'input_dim': d, 'channel': [8, c], 'kernel_size': 3}
              for m, d, c in (('video', 512, 128), ('vggish', 128, 8),
                              ('bert', 768, 8))}
    family_batch = {
        'video': rng.normal(size=(2, 6, 512)).astype(np.float32),
        'vggish': rng.normal(size=(2, 6, 128)).astype(np.float32),
        'bert': rng.normal(size=(2, 6, 768)).astype(np.float32),
        'EXPR_continuous_label': rng.integers(0, 7, (2, 6))}
    for family in (CAN(('vggish', 'bert'), 7, tcn_settings=narrow),
                   JMT(('video', 'vggish'), 7, model_name='MT',
                       tcn_settings=narrow)):
        batch = {k: v for k, v in family_batch.items()
                 if k in family.modality or 'label' in k}
        loss = Trainer(family, get_train_config(), 'cpu').train_one_epoch(
            [batch], 0)
        assert np.isfinite(loss), loss
        params, _ = flax_from_state({k: v for k, v in
                                     family.state_dict().items()
                                     if not k.startswith('spatial.')})
        assert 'fuse' in params, list(params)

    from fvt_tpu_torch.models.arcface import (CONV_IMPLS, VisualBackbone,
                                              arcface_forward_eval)
    import fvt_tpu_torch.tools.profile_backbone
    import fvt_tpu_torch.tools.profile_conv_bf16
    import fvt_tpu_torch.tools.profile_train

    base = VisualBackbone().eval()
    base.reset_parameters(torch.Generator().manual_seed(0))
    crops = torch.from_numpy(rng.uniform(-1, 1, (1, 40, 40, 3))
                             .astype(np.float32))
    want = arcface_forward_eval(base, crops)
    variants = [VisualBackbone(conv_impl=impl) for impl in CONV_IMPLS
                if impl != 'int8']
    variants.append(VisualBackbone(fused_blocks=True))
    for variant in variants:
        variant.eval().load_state_dict(base.state_dict())
        with torch.inference_mode():
            got = variant(crops)
        assert got.shape == (1, 512) and torch.isfinite(got).all()
        assert (got - want).abs().max() < 1e-4, (got - want).abs().max()

    # int8 serving: calibrated, its scales in fvt_tpu's tree and back, the
    # bfloat16 host rounding without ml_dtypes
    import fvt_tpu_torch.tools.quant_delta
    from fvt_tpu_torch.utils import bf16
    q = VisualBackbone(conv_impl='int8')
    q.load_state_dict(base.state_dict())
    q.begin_calibration()
    with torch.inference_mode():
        emb = q(crops)
    q.end_calibration()
    assert q.int8_mode() == 'static' and len(q.int8_convs()) == 41
    assert float((emb * want).sum()) > 0.97
    fresh = VisualBackbone(conv_impl='int8')
    fresh.load_state_dict(base.state_dict())
    fresh.load_act_scales(q.act_scales())
    with torch.inference_mode():
        assert torch.equal(fresh(crops), emb)
    bits = bf16.bf16_bits(np.array([1.0, np.nan, 1 + 2 ** -8], np.float32))
    assert bits.tolist() == [0x3f80, 0x7fc0, 0x3f80], bits

    amp = VisualBackbone('shifted_kernel', dtype=torch.bfloat16).eval()
    amp.load_state_dict(base.state_dict())
    got = arcface_forward_eval(amp, crops, dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert 0 < (got - want).abs().max() < 2e-2, (got - want).abs().max()

    import os
    import tempfile
    from fvt_tpu_torch.config import flat_yaml
    from fvt_tpu_torch.config.defaults import get_config, to_namespace
    from fvt_tpu_torch.inference_challenge import main
    from fvt_tpu_torch.models.registry import init_model
    from fvt_tpu_torch.tools.synth_store import make_cexpr_store

    with tempfile.TemporaryDirectory() as root:
        store = make_cexpr_store(os.path.join(root, 'store'), [5, 13])
        run = os.path.join(root, 'run')
        os.makedirs(os.path.join(run, 'best-models', 'case'))
        cfg = get_config('MELD')
        cfg.update(modality='vggish+bert+EXPR_continuous_label',
                   window_length=8, hop_length=4, eval_bucket_quantum=8,
                   verbose=False)
        flat_yaml.dump(cfg, os.path.join(run, 'config.yml'))
        torch.save(init_model(to_namespace(cfg)).state_dict(),
                   os.path.join(run, 'best-models', 'case', 'model.pt'))
        exp = main(['--mode', 'EVALUATION', '--fd_exp', run,
                    '--dataset_path', store['dataset_path'],
                    '--folds_dir', store['folds_dir']], device='cpu')
        assert exp.trainer.last_inference_timing['h2d_bytes'] > 0
        assert os.path.isfile(os.path.join(
            run, 'eval-C-EXPR-DB-CHALLENGE', 'pred-C-EXPR-DB-CHALLENGE',
            'prediction.pkl'))

        import fvt_tpu_torch.main
        import fvt_tpu_torch.train.checkpoint

        store = make_cexpr_store(os.path.join(root, 'train_store'), [9, 14],
                                 ds='C-EXPR-DB', val_lengths=[6, 11])
        argv = ['--dataset_name', 'C-EXPR-DB', '--dataset_path',
                store['dataset_path'], '--folds_dir', store['folds_dir'],
                '--modality', 'vggish+bert+EXPR_continuous_label',
                '--num_epochs', '2', '--train_batch_size', '2',
                '--num_workers', '1', '--window_length', '8',
                '--hop_length', '4', '--eval_bucket_quantum', '8',
                '--checkpoint_every', '1', '--verbose', 'false',
                '--outd', os.path.join(root, 'trained')]
        fvt_tpu_torch.main.main(argv, device='cpu')
        os.remove(os.path.join(root, 'trained', 'passed.txt'))
        exp = fvt_tpu_torch.main.main(
            argv[:-1] + [os.path.join(root, 'trained'), '--num_epochs', '3',
                         '--resume', 'true'], device='cpu')
        assert len(exp.trainer.loss_tracker) == 3
        assert os.path.isfile(os.path.join(
            root, 'trained', 'best-models', 'None', 'model.msgpack'))

        # the challenge run's best model exported, loaded, served over
        # HTTP through the numpy-only client and by artifact inference
        import threading
        from fvt_tpu_torch.client import ServingClient
        from fvt_tpu_torch.export import load_artifact
        from fvt_tpu_torch.tools import (export_serving, infer_artifact,
                                         serve_http)
        path = export_serving.main(['--fd_exp', run, '--window_batch', '2'])[
            'artifact']
        art = load_artifact(path, device='cpu')
        srv = serve_http.build_server(path, device='cpu')
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        feats = {'vggish': rng.normal(size=(2, 8, 128)).astype(np.float32),
                 'bert': rng.normal(size=(2, 8, 768)).astype(np.float32)}
        got = ServingClient(f'http://127.0.0.1:{srv.server_port}').logits(
            feats)
        assert (got == art.call(feats)).all()
        serve_http.drain_and_shutdown(srv, timeout_s=1)
        store = make_cexpr_store(os.path.join(root, 'store2'), [5, 13])
        infer_artifact.main(['--mode', 'EVALUATION', '--fd_exp', run,
                             '--dataset_path', store['dataset_path'],
                             '--folds_dir', store['folds_dir'],
                             '--artifact', path], device='cpu')

    # a logmel model (the frozen VGGish) serves, and its VGGish goes to
    # fvt_tpu's tree; the regression trainer fits an epoch and tests
    from fvt_tpu_torch.models.fusion_extra import TCNAttentionBlock
    from fvt_tpu_torch.models.tcn import TemporalConvNet
    tcn_attn = TemporalConvNet(4, [8, 8], 3, attention=1, max_length=6)
    tcn_attn.reset_parameters(torch.Generator().manual_seed(0))
    assert isinstance(tcn_attn.attn[1], TCNAttentionBlock)
    with torch.inference_mode():
        assert tcn_attn(torch.randn(2, 6, 4)).shape == (2, 6, 8)

    from fvt_tpu_torch.models.vggish import VGGish
    logmel = LFAN(('logmel', 'bert'), 7, tcn_channel=tcn_logmel,
                  encoder_dim={'logmel': 4, 'bert': 4},
                  generator=torch.Generator().manual_seed(0))
    assert isinstance(logmel.spatial.audio.backbone, VGGish)
    with torch.inference_mode():
        logits = logmel({'logmel': torch.randn(1, 2, 96, 64),
                         'bert': torch.randn(1, 2, 768)})
    assert logits.shape == (1, 2, 7) and torch.isfinite(logits).all()
    params, _ = flax_from_state(logmel.state_dict(), ('logmel', 'bert'))
    assert 'fc0' in params['spatial_audio'], list(params)

    from types import SimpleNamespace
    from fvt_tpu_torch.train.param_control import ParamControl
    from fvt_tpu_torch.train.regression_trainer import RegressionTrainer
    import fvt_tpu_torch.train.losses
    import fvt_tpu_torch.train.regression_viz
    reg = LFAN(('vggish', 'bert'), 1, task='REGRESSION', tcn_channel=tcn,
               encoder_dim={'vggish': 4, 'bert': 4},
               generator=torch.Generator().manual_seed(0))
    reg_batch = ({'vggish': rng.normal(size=(2, 6, 128)).astype(np.float32),
                  'bert': rng.normal(size=(2, 6, 768)).astype(np.float32),
                  'VA_continuous_label': rng.uniform(-1, 1, (2, 6))
                  .astype(np.float32)},
                 ['t0', 't0'], [8, 8], np.array([np.arange(6),
                                                 np.arange(2, 8)]))
    with tempfile.TemporaryDirectory() as outd:
        reg_args = SimpleNamespace(**get_config('MELD'))
        reg_args.__dict__.update(num_epochs=2, min_num_epochs=1,
                                 early_stopping=0, outd=outd,
                                 milestone=(1,), save_plot=False)
        trainer = RegressionTrainer(
            reg, reg_args, ParamControl([['temporal']], 1, ['regressor']),
            device='cpu')
        trainer.init_state(reg_batch[0])
        best = trainer.fit(lambda epoch: [reg_batch], lambda: [reg_batch])
        assert np.isfinite(best['ccc']), best
        assert np.isfinite(trainer.test(lambda: [reg_batch])[0])
        assert os.path.isfile(os.path.join(outd,
                                           'model_state_dict.msgpack'))

    import chip_smoke
    leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not leaked, leaked
    print('served', out.shape, 'trained', len(variants), 'backbones')
''')

# an import of jax, flax, yaml, msgpack, orbax, ml_dtypes or fvt_tpu (not
# fvt_tpu_torch), at any depth
FORBIDDEN_IMPORT = re.compile(
    r'^\s*(?:import|from)\s+'
    r'(?:jax|jaxlib|flax|yaml|msgpack|orbax|ml_dtypes|fvt_tpu)(?![\w])',
    re.MULTILINE)


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (REPO, env.get('PYTHONPATH')) if p)
    return env


def _port_sources():
    yield os.path.join(REPO, 'chip_smoke.py')
    for root, _, files in os.walk(os.path.join(REPO, 'fvt_tpu_torch')):
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(root, name)


def test_no_port_source_imports_jax_or_fvt_tpu():
    paths = list(_port_sources())
    assert len(paths) > 25
    names = {os.path.relpath(p, REPO) for p in paths}
    assert {'fvt_tpu_torch/ops/conv.py', 'fvt_tpu_torch/ops/winograd.py',
            'fvt_tpu_torch/models/arcface.py',
            'fvt_tpu_torch/ops/bottleneck.py',
            'fvt_tpu_torch/tools/profile_backbone.py',
            'fvt_tpu_torch/inference_challenge.py',
            'fvt_tpu_torch/config/flat_yaml.py',
            'fvt_tpu_torch/models/checkpoint.py',
            'fvt_tpu_torch/models/to_jax.py',
            'fvt_tpu_torch/train/checkpoint.py',
            'fvt_tpu_torch/main.py',
            'fvt_tpu_torch/data/loader.py',
            'fvt_tpu_torch/data/transforms.py',
            'fvt_tpu_torch/train/steps.py',
            'fvt_tpu_torch/models/models.py',
            'fvt_tpu_torch/models/fusion.py',
            'fvt_tpu_torch/models/layers.py',
            'fvt_tpu_torch/models/vggish.py',
            'fvt_tpu_torch/train/losses.py',
            'fvt_tpu_torch/train/param_control.py',
            'fvt_tpu_torch/train/regression_trainer.py',
            'fvt_tpu_torch/train/regression_viz.py',
            'fvt_tpu_torch/serve.py',
            'fvt_tpu_torch/export.py',
            'fvt_tpu_torch/client.py',
            'fvt_tpu_torch/streaming.py',
            'fvt_tpu_torch/models/fusion_extra.py',
            'fvt_tpu_torch/tools/export_serving.py',
            'fvt_tpu_torch/tools/serve_http.py',
            'fvt_tpu_torch/tools/infer_artifact.py',
            'fvt_tpu_torch/ops/quant.py',
            'fvt_tpu_torch/tools/quant_delta.py',
            'fvt_tpu_torch/utils/bf16.py'} <= names
    for path in paths:
        with open(path) as f:
            found = FORBIDDEN_IMPORT.findall(f.read())
        assert not found, (os.path.relpath(path, REPO), found)
    assert FORBIDDEN_IMPORT.search('    from fvt_tpu.data import windowing')
    assert FORBIDDEN_IMPORT.search('import jax.numpy as jnp')
    assert FORBIDDEN_IMPORT.search('import msgpack')
    assert FORBIDDEN_IMPORT.search('import orbax.checkpoint as ocp')
    assert FORBIDDEN_IMPORT.search('        import ml_dtypes')
    assert not FORBIDDEN_IMPORT.search('from fvt_tpu_torch import constants')


def test_port_imports_and_serves_without_jax_flax_yaml():
    proc = subprocess.run([sys.executable, '-c', NO_JAX], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'served (9, 7) trained 5 backbones' in proc.stdout


def test_chip_smoke_refuses_a_machine_without_cuda():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip('needs a machine without a CUDA card')
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert 'no CUDA device' in proc.stderr
