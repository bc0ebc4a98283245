"""CLI parsing, config merge and run-directory set-up (tiers 2 and 3), as
``fvt_tpu/config/parse.py`` does them, with ``config.yml`` written and
read by :mod:`fvt_tpu_torch.config.flat_yaml` (no PyYAML):

* every config key is a flag; None keeps the default;
* ``sanity_check`` asserts what ``fvt_tpu`` asserts;
* TRAINING derives a fresh ``outd`` and writes ``config.yml`` (in a
  data-parallel run, rank 0 alone, its ``outd`` broadcast to the others,
  whose logger writes nothing);
* EVALUATION reads a finished run's ``config.yml`` and retargets it to
  the evaluated dataset (fold 0, no subsampling, no workers, the folds
  and the explicit CLI overrides), as ``_parse_eval`` there does.
"""
from __future__ import annotations

import argparse
import datetime as dt
import os
import sys
from os.path import join
from types import SimpleNamespace

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import flat_yaml
from fvt_tpu_torch.config.defaults import get_config
from fvt_tpu_torch.parallel import mesh
from fvt_tpu_torch.utils.logger import fmsg, init_logger, log

SERVE_QUANT = ('none', 'int8', 'int8_static')
# the CLI flags that EVALUATION takes over the training run's config
EVAL_OVERRIDES = ('dataset_path', 'folds_dir', 'outd', 'eval_bucket_quantum',
                  'train_p', 'valid_p', 'test_p', 'serve_quant',
                  'pallas_serving')


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise argparse.ArgumentTypeError('boolean value expected')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='fvt_tpu_torch')
    parser.add_argument('--dataset_name', type=str, default=constants.MELD)
    parser.add_argument('--mode', type=str, default=None)
    parser.add_argument('--fd_exp', type=str, default=None,
                        help='EVALUATION: dir of a finished TRAINING run')
    parser.add_argument('--target_ds_name', type=str, default=None,
                        help='EVALUATION: dataset to retarget to')
    parser.add_argument('--eval_set', type=str, default=None,
                        help='EVALUATION: split to evaluate')
    parser.add_argument('--case_best_model', type=str, default=None,
                        help='EVALUATION: which best-model criterion')
    parser.add_argument('--device', type=str, default=None,
                        help="the run's device (no config key): the card "
                             "by default, 'cpu' for the CPU")

    # every default key becomes an override flag
    for k, v in get_config(constants.MELD).items():
        if k in ('dataset_name', 'mode'):
            continue
        if isinstance(v, bool):
            parser.add_argument(f'--{k}', type=str2bool, default=None)
        elif isinstance(v, int):
            parser.add_argument(f'--{k}', type=int, default=None)
        elif isinstance(v, float):
            parser.add_argument(f'--{k}', type=float, default=None)
        else:
            parser.add_argument(f'--{k}', type=str, default=None)
    return parser


def check_serve_quant(config: dict) -> None:
    sq = config.get('serve_quant', 'none')
    assert sq in SERVE_QUANT, sq
    if sq == 'int8_static':
        # the serving step applies the backbone itself and would drop the
        # calibrated static scales
        assert not config.get('pallas_serving', False), \
            '--serve_quant int8_static is incompatible with ' \
            '--pallas_serving (use dynamic int8 there)'


def sanity_check(config: dict):
    assert config['dataset_name'] in constants.DATASETS
    assert config['model_name'] in constants.FUSION_METHODS
    modalities = config['modality'].split('+')
    assert len(modalities) > 0
    for m in modalities:
        assert m in constants.MODALITIES + ['logmel'], m
    assert constants.EXPR in modalities, \
        f"modality must include {constants.EXPR}"
    if config['use_other_class']:
        assert config['dataset_name'] == constants.C_EXPR_DB
    assert config['opt__name_optimizer'] in constants.OPTIMIZERS
    assert config['opt__name_lr_scheduler'] in constants.LR_SCHEDULERS
    # MYWARMUP's plateau decay reads the validation W-F1 (higher is better)
    if (config['opt__name_lr_scheduler'] == constants.MYWARMUP
            and config.get('task') == constants.CLASSIFICATION):
        assert config['opt__mode'] == constants.MAX_MODE, \
            ('MYWARMUP with a classification task tracks the validation '
             'W-F1 master metric (higher is better): set --opt__mode '
             f'{constants.MAX_MODE}, got {config["opt__mode"]!r}')
    assert not config.get('window_eval', False), \
        'window_eval=True is unsupported: eval uses whole videos + the ' \
        'window-stitch inference path for long LFAN videos'
    check_serve_quant(config)
    if config.get('serve_quant', 'none') != 'none':
        assert config.get('mode') != constants.TRAINING, \
            '--serve_quant is inference-only (use it with --mode ' \
            'EVALUATION / inference_challenge)'


def make_outd(config: dict, base: str = None) -> str:
    base = base or join(os.getcwd(), 'exps')
    stamp = dt.datetime.now().strftime('%m-%d-%H-%M-%S-%f')
    tag = (f"{config['dataset_name']}-{config['model_name']}"
           f"-fold{config['fold_to_run']}-{config['exp_id']}-{stamp}")
    outd = join(base, tag)
    os.makedirs(outd, exist_ok=True)
    return outd


def save_config(config: dict, path: str) -> None:
    """``config.yml``: datetimes as their str, as ``fvt_tpu`` writes it."""
    flat_yaml.dump({k: str(v) if isinstance(v, dt.datetime) else v
                    for k, v in config.items()}, path)


def parse_input(argv=None, world=None) -> SimpleNamespace:
    """The run's config from ``argv``; ``world`` (``parallel/mesh.py``)
    for a rank of a data-parallel run."""
    parser = build_parser()
    args = parser.parse_args(argv)

    assert args.mode is None or args.mode in constants.MODES, \
        f"--mode must be one of {constants.MODES}, got {args.mode!r}"
    if args.mode == constants.EVALUATION:
        return _parse_eval(args)

    config = get_config(args.dataset_name)
    for k, v in vars(args).items():
        if k in ('fd_exp', 'target_ds_name', 'eval_set', 'case_best_model'):
            continue
        if v is not None and k in config:
            config[k] = v
    config['mode'] = constants.TRAINING
    sanity_check(config)

    writer = world is None or world.writer
    if not config['outd']:
        config['outd'] = mesh.broadcast(world, make_outd(config) if writer
                                        else None)
    os.makedirs(config['outd'], exist_ok=True)

    if os.path.isfile(join(config['outd'], 'passed.txt')):
        print(f"Experiment {config['outd']} already passed. Exiting.")
        sys.exit(0)

    config['t0'] = dt.datetime.now()
    if not writer:
        init_logger(None, verbose=False)
        return SimpleNamespace(**config)
    init_logger(config['outd'], verbose=config['verbose'])
    log(fmsg(f"Starting experiment: {config['outd']}"))
    save_config(config, join(config['outd'], 'config.yml'))
    return SimpleNamespace(**config)


def _parse_eval(args) -> SimpleNamespace:
    """EVALUATION: read the finished run's config, retarget the dataset."""
    fd_exp = args.fd_exp
    assert fd_exp and os.path.isdir(fd_exp), fd_exp
    config = flat_yaml.load(join(fd_exp, 'config.yml'))

    target_ds = args.target_ds_name or constants.C_EXPR_DB_CHALLENGE
    config['mode'] = constants.EVALUATION
    config['dataset_name'] = target_ds
    # num_classes stays the training config's: the head must match the
    # checkpoint
    config['fold_to_run'] = 0
    config['num_workers'] = 0
    config['fd_exp'] = fd_exp
    # eval_set names the output artifacts (eval-<set>-perf.pkl etc.)
    config['eval_set'] = args.eval_set or constants.TESTSET
    assert config['eval_set'] in (constants.TRAINSET, constants.VALIDSET,
                                  constants.TESTSET), config['eval_set']
    config['case_best_model'] = args.case_best_model
    # folds retargeted to the eval dataset; the training run's debug
    # subsampling undone (it would drop challenge videos from the dump)
    config['folds_dir'] = join(os.path.dirname(
        config.get('folds_dir', 'folds')), target_ds)
    config['train_p'] = config['valid_p'] = config['test_p'] = 100.0
    config['num_folds'] = 1
    config['outd'] = join(config['fd_exp'], f"eval-{target_ds}")

    for k, v in vars(args).items():  # explicit CLI overrides still win
        if v is not None and k in EVAL_OVERRIDES:
            config[k] = v
    check_serve_quant(config)

    assert os.path.isdir(config['folds_dir']), (
        f"eval folds_dir not found: {config['folds_dir']!r} — the "
        f"training run's folds root was retargeted to {target_ds}; pass "
        f"--folds_dir explicitly when the eval dataset's folds live "
        f"elsewhere (e.g. <dataset_path>/folds/{target_ds})")

    os.makedirs(config['outd'], exist_ok=True)
    config['t0'] = dt.datetime.now()
    init_logger(config['outd'], verbose=config.get('verbose', True))
    log(fmsg(f"Evaluation run: {config['outd']} (model from {fd_exp})"))
    return SimpleNamespace(**config)
