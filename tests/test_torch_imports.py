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
carried, the bfloat16 host rounding, the audio extractors (log-mel
patches, VGGish embeddings from a vggish.pth, MFCC) on a wav it writes,
the visual preprocessing (RetinaFace, the warp, FAN, AU maps) and a
feature-driver shard with cnn.npy and landmarks, merged, the run tools
(a synthetic MELD store validated, a checkpoint ported both ways, a
data-parallel training CLI run in a one-rank gloo group, summarised), a
DP train step and the artifact served by call_sharded in that group,
with all of them, cv2 and opensmile blocked), and
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
               'ml_dtypes', 'fvt_tpu', 'cv2', 'opensmile')

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

    # the audio extractors on a wav of their own: log-mel patches and a
    # VGGish loaded from an upstream-named vggish.pth, MFCC on the host
    from fvt_tpu_torch.preprocess import audio, melspec, mfcc
    from fvt_tpu_torch.preprocess.sharding import annotated_index
    with tempfile.TemporaryDirectory() as root:
        wav = os.path.join(root, 'clip.wav')
        melspec.write_wav(wav, rng.integers(-3000, 3000, 4000, np.int16),
                          16000)
        idx = annotated_index(12, 25.0)
        audio.extract_logmel(wav, os.path.join(root, 'logmel.npy'),
                             hop_sec=1 / 25, annotated_idx=idx,
                             device='cpu')
        logmel_npy = np.load(os.path.join(root, 'logmel.npy'))
        assert logmel_npy.shape == (12, 96, 64), logmel_npy.shape
        assert logmel_npy.dtype == np.float16
        pth = os.path.join(root, 'vggish.pth')
        torch.save(VGGish().state_dict(), pth)
        emb = audio.extract_vggish_embeddings(
            wav, audio.vggish_from_pth(pth, device='cpu'), 0.96, 1 / 25,
            annotated_idx=idx, device='cpu')
        assert emb.shape == (12, 128) and np.isfinite(emb).all()
        mfcc.extract_mfcc(wav, os.path.join(root, 'mfcc.npy'), idx, 1 / 25)
        assert np.load(os.path.join(root, 'mfcc.npy')).shape == (12, 39)

    # the visual preprocessing and the feature driver: every module, the
    # detector, the warp and the FAN on the CPU, then a shard (cnn.npy,
    # landmarks, log-mel patches) on a wav with an injected probe, merged
    from fvt_tpu_torch.models.from_jax import (fan_state_from_flax,
                                               retinaface_state_from_flax)
    from fvt_tpu_torch.preprocess import (action_units, au_ellipsoids,
                                          compact, driver, facealign, faces,
                                          fan, merge, recompact, retinaface,
                                          splits, textalign, visual)
    det = retinaface.RetinaFaceR50(model=retinaface.RetinaFaceNet(),
                                   confidence_threshold=0.0, max_size=64,
                                   device='cpu')
    assert det.detect(rng.integers(0, 256, (48, 64, 3), np.uint8))
    with torch.inference_mode():
        assert fan.FAN().eval()(torch.zeros(1, 64, 64, 3)).shape == (
            1, 16, 16, 68)
    assert action_units.batched_au_heatmaps(
        rng.uniform(20, 40, (2, 68, 2)), 16, device='cpu').shape == (
        2, 8, 16, 16)
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, 'folds', 'split-0'))
        with open(os.path.join(root, 'folds', 'split-0', 'train.txt'),
                  'w') as f:
            f.write('t0,2,hello\\n')
        os.makedirs(os.path.join(root, 'videos'))
        open(os.path.join(root, 'videos', 't0.mp4'), 'w').close()
        shard = os.path.join(root, 'shard')
        os.makedirs(os.path.join(shard, 'features', 'wav'))
        melspec.write_wav(os.path.join(shard, 'features', 'wav', 't0.wav'),
                          rng.integers(-3000, 3000, 16000, np.int16), 16000)
        frames = rng.integers(0, 256, (5, 72, 96, 3), np.uint8)
        crops = faces.process_frames(iter(frames), os.path.join(root, 'c'),
                                     faces.CenterBoxDetector(),
                                     store_jpgs=False, device='cpu')
        tdir = os.path.join(shard, 'features', 'compacted_48', 't0')
        os.makedirs(tdir)
        faces.compact_video_npy(tdir, crops)
        records = driver.PreprocessingDriver(
            'MELD', 'train', 0, 1, os.path.join(root, 'videos'), shard,
            os.path.join(root, 'folds'), arcface=base,
            landmarker=lambda img: np.ones((68, 2), np.float32),
            probe=lambda path: (5.0, 5), device='cpu').run()
        assert records[0]['processing_record']['issues'] == [], records
        for feature, shape in (('cnn', (5, 512)), ('landmark', (5, 136)),
                               ('logmel', (5, 96, 64)), ('bert', (5, 768))):
            got = np.load(os.path.join(tdir, feature + '.npy')).shape
            assert got == shape, (feature, got)
        info = merge.merge_results(os.path.join(shard, 'features'), 'MELD',
                                   'train')
        assert info['trial'] == ['t0'] and info['length'] == [5]

    # the run tools and data-parallel training, a one-rank gloo group
    import fvt_tpu_torch.tools.cv_campaign
    import fvt_tpu_torch.tools.quickstart
    from fvt_tpu_torch import main as train_cli
    from fvt_tpu_torch.models.checkpoint import msgpack_restore
    from fvt_tpu_torch.parallel import dp, mesh, multihost
    from fvt_tpu_torch.tools import (port_checkpoint, summarize_runs,
                                     validate_store)
    from fvt_tpu_torch.tools.synth_store import make_meld_store
    from fvt_tpu_torch.train import optim
    from fvt_tpu_torch.utils import rng as rng_mod
    assert mesh.join('cpu') is None
    assert multihost.host_slice(6, 1, 2) == (3, 6)
    assert multihost.host_slice(5, 1, 2) is None
    blob = port_checkpoint.family_msgpack(model.state_dict(), 'LFAN',
                                          ['vggish', 'bert'])
    back = port_checkpoint.upstream_state_dict(msgpack_restore(blob),
                                               'LFAN', ['vggish', 'bert'])
    # flax keeps no num_batches_tracked: the way back writes 0
    assert all(torch.equal(back[k], v)
               for k, v in model.state_dict().items()
               if not k.endswith('num_batches_tracked'))
    with tempfile.TemporaryDirectory() as root:
        store = make_meld_store(os.path.join(root, 'store'), n_train=3,
                                n_val=1, n_test=1, min_len=4, max_len=9)
        rep = validate_store.validate(store['dataset_path'], 'MELD',
                                      folds_dir=store['folds_dir'],
                                      deep=True).as_dict()
        assert rep['ok'], rep
        os.environ.update(MASTER_ADDR='localhost', RANK='0', WORLD_SIZE='1',
                          MASTER_PORT='0')  # one rank: it binds
        world = mesh.join('cpu')
        step = dp.DPTrainStep(model, optim.standardize_opt_params(
            get_train_config()), world)
        rows = {'vggish': rng.normal(size=(2, 6, 128)).astype(np.float32),
                'bert': rng.normal(size=(2, 6, 768)).astype(np.float32),
                'EXPR_continuous_label': rng.integers(0, 7, (2, 6))}
        assert np.isfinite(float(step(rows, rng_mod.generator(0), 2)))
        exp = train_cli.main([
            '--dataset_name', 'MELD', '--dataset_path',
            store['dataset_path'], '--folds_dir', store['folds_dir'],
            '--modality', 'vggish+bert+EXPR_continuous_label',
            '--num_epochs', '1', '--window_length', '8', '--hop_length',
            '4', '--eval_bucket_quantum', '8', '--num_workers', '1',
            '--data_parallel', 'true', '--outd', os.path.join(root, 'run'),
            '--device', 'cpu'])
        assert exp.trainer.world.size == 1
        # the served artifact data-parallel over the same one-rank group
        assert (art.call_sharded(feats, mesh=world) == art.call(feats)).all()
        art.stop_followers(world)
        mesh.leave(world)
        summary = summarize_runs.summarize([root])
        assert len(summary['runs']) == 3, summary

    import chip_smoke
    leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not leaked, leaked
    print('served', out.shape, 'trained', len(variants), 'backbones')
''')

# an import of jax, flax, yaml, msgpack, orbax, ml_dtypes, cv2 or fvt_tpu
# (not fvt_tpu_torch), at any depth
FORBIDDEN_IMPORT = re.compile(
    r'^\s*(?:import|from)\s+'
    r'(?:jax|jaxlib|flax|yaml|msgpack|orbax|ml_dtypes|cv2|fvt_tpu)(?![\w])',
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
            'fvt_tpu_torch/utils/bf16.py',
            'fvt_tpu_torch/preprocess/sharding.py',
            'fvt_tpu_torch/preprocess/melspec.py',
            'fvt_tpu_torch/preprocess/audio.py',
            'fvt_tpu_torch/preprocess/mfcc.py',
            'fvt_tpu_torch/preprocess/egemaps.py',
            'fvt_tpu_torch/preprocess/facealign.py',
            'fvt_tpu_torch/preprocess/retinaface.py',
            'fvt_tpu_torch/preprocess/fan.py',
            'fvt_tpu_torch/preprocess/action_units.py',
            'fvt_tpu_torch/preprocess/au_ellipsoids.py',
            'fvt_tpu_torch/preprocess/faces.py',
            'fvt_tpu_torch/preprocess/visual.py',
            'fvt_tpu_torch/preprocess/compact.py',
            'fvt_tpu_torch/preprocess/recompact.py',
            'fvt_tpu_torch/preprocess/textalign.py',
            'fvt_tpu_torch/preprocess/driver.py',
            'fvt_tpu_torch/preprocess/merge.py',
            'fvt_tpu_torch/preprocess/splits.py',
            'fvt_tpu_torch/parallel/mesh.py',
            'fvt_tpu_torch/parallel/multihost.py',
            'fvt_tpu_torch/parallel/dp.py',
            'fvt_tpu_torch/parallel/collectives.py',
            'fvt_tpu_torch/parallel/serving.py',
            'fvt_tpu_torch/tools/synth_store.py',
            'fvt_tpu_torch/tools/validate_store.py',
            'fvt_tpu_torch/tools/summarize_runs.py',
            'fvt_tpu_torch/tools/port_checkpoint.py',
            'fvt_tpu_torch/tools/quickstart.py',
            'fvt_tpu_torch/tools/cv_campaign.py'} <= names
    for path in paths:
        with open(path) as f:
            found = FORBIDDEN_IMPORT.findall(f.read())
        assert not found, (os.path.relpath(path, REPO), found)
    assert FORBIDDEN_IMPORT.search('    from fvt_tpu.data import windowing')
    assert FORBIDDEN_IMPORT.search('import jax.numpy as jnp')
    assert FORBIDDEN_IMPORT.search('import msgpack')
    assert FORBIDDEN_IMPORT.search('import orbax.checkpoint as ocp')
    assert FORBIDDEN_IMPORT.search('        import ml_dtypes')
    assert FORBIDDEN_IMPORT.search('import cv2')
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
