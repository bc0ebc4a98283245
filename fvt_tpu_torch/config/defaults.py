"""Per-dataset default config of the port (tier 1 of 3): the whole of
``fvt_tpu/config/defaults.py``, every key with that file's value
(``tests/test_torch_copies.py`` holds ``get_config`` equal to it for
every dataset).  Every key is a CLI flag (``config/parse.py``, tier 2), and
a run's merged config is written to ``<outd>/config.yml`` (tier 3), which
EVALUATION mode reads back.

``data_parallel`` and ``multihost_digest_check`` mean what they mean in
``fvt_tpu``: data-parallel training over the visible GPUs, one process
each (``main.py``, ``parallel/``), and the all-gathered digest of every
replicated batch.  ``pallas_train`` steers ``fvt_tpu``'s XLA programs and
means nothing to the port; it is kept so that a ``config.yml`` of either
package loads in the other.  ``pallas_serving`` is accepted: on the card
the port's eval always runs the fused TCN and fusion kernels.
"""
from __future__ import annotations

import os
from os.path import join
from types import SimpleNamespace

from fvt_tpu_torch import constants

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the keys the port's Trainer reads for optimizer steps
TRAIN_KEYS = ('seed', 'task', 'num_epochs', 'min_num_epochs', 'window_length',
              'hop_length', 'train_batch_size', 'nan_guard',
              'opt__weight_decay', 'opt__name_optimizer', 'opt__lr',
              'opt__honor_lr', 'opt__momentum', 'opt__dampening',
              'opt__nesterov', 'opt__beta1', 'opt__beta2', 'opt__eps_adam',
              'opt__amsgrad', 'opt__lr_scheduler', 'opt__name_lr_scheduler',
              'opt__coef', 'opt__gamma', 'opt__step_size', 'opt__min_lr',
              'opt__t_max', 'opt__mode', 'opt__factor', 'opt__patience',
              'opt__milestone')


def get_config(ds: str) -> dict:
    assert ds in constants.DATASETS, ds
    return {
        'dataset_name': ds,
        'num_classes': constants.NUM_CLASSES[ds],
        'task': constants.DS_TASK[ds],
        'train_p': 100.,
        'valid_p': 100.,
        'test_p': 100.,

        'outd': '',
        'exp_id': '123456',
        't0': 'STARTING_TIME',
        'tend': 'FINISHING_TIME',

        'seed': 0,
        'verbose': True,
        'mode': constants.TRAINING,
        'resume': False,
        'modality': 'video+vggish+bert+EXPR_continuous_label',
        'calc_mean_std': True,
        'emotion': '???',

        'model_name': constants.LFAN,
        'num_folds': 1,
        'fold_to_run': 0,
        'folds_dir': join(REPO_ROOT, 'folds', ds),

        'amp': False,  # the backbone computes in bfloat16

        'num_heads': 2,
        'modal_dim': 32,
        'tcn_kernel_size': 5,

        'num_epochs': 100,
        'min_num_epochs': 5,
        'early_stopping': 50,  # epochs with no validation gain; 0 = off
        'window_length': 300,
        'hop_length': 200,
        'window_eval': False,  # must stay False: eval takes whole videos
        # and stitches the windows of a video longer than the window

        'train_batch_size': 16,
        'eval_batch_size': 1,
        'num_workers': 6,

        'opt__weight_decay': 0.0001,
        'opt__name_optimizer': constants.SGD,
        'opt__lr': 0.001,
        'opt__honor_lr': False,  # see train/optim.py::effective_base_lr
        'opt__momentum': 0.9,
        'opt__dampening': 0.0,
        'opt__nesterov': True,
        'opt__beta1': 0.9,
        'opt__beta2': 0.999,
        'opt__eps_adam': 1e-8,
        'opt__amsgrad': False,

        'opt__lr_scheduler': True,
        'opt__name_lr_scheduler': constants.MYSTEP,
        'opt__coef': 0.5,           # MYCOSINE coefficient
        'opt__gamma': 0.1,
        'opt__step_size': 40,
        'opt__last_epoch': -1,
        'opt__min_lr': 1e-7,
        'opt__t_max': 100,
        'opt__mode': constants.MIN_MODE,
        'opt__factor': 0.5,
        'opt__patience': 10,
        'opt__gradual_release': 1,
        'opt__release_count': 3,
        'opt__milestone': '0',
        'opt__load_best_at_each_epoch': True,

        'time_delay': 0,
        'metrics': 'nrmse',
        'save_plot': False,
        'dataset_path': '',
        'load_path': join(REPO_ROOT, 'pretrained_models'),
        'save_path': '',
        'pretrained_torch_ckpt': '',  # an upstream model.pt to start from

        'use_other_class': False,

        'eval_bucket_quantum': 100,   # eval pads a video to a multiple
        'eval_video_batch': 32,       # same-bucket videos in one forward
        'train_bucketed': False,      # pad short train clips only to the
        # next train_bucket_quantum multiple (changes the loss weighting)
        'train_bucket_quantum': 100,
        'frozen_eval_backbones': False,  # frozen encoders in eval mode
        # during training (not the upstream contract)
        'h2d_bf16_features': False,   # eval: feature streams rounded to
        # bfloat16 on the host, widened to float32 on the device
        'h2d_precrop_video': True,    # eval: the 40^2 center crop taken on
        # the host (bit-identical logits)
        'eval_device_windows': True,  # a long video is uploaded once and
        # its windows gathered on the device; False: pooled host windows
        'eval_window_batch': 8,       # windows in one forward
        'host_resize': True,          # raw 256^2 faces resized to 48 on
        # the host
        'data_parallel': False,
        'checkpoint_every': 0,
        'profile_epochs': 0,          # epochs traced by torch.profiler
        'nan_guard': False,           # per-step finite-loss assertion
        'multihost_digest_check': False,
        'serve_quant': 'none',        # 'int8' / 'int8_static': the frozen
        # ArcFace's convs of >= 128 channels in int8 (ops/quant.py)
        'pallas_serving': False,
        'pallas_train': False,
    }


def get_train_config() -> dict:
    """The keys the port's Trainer reads for optimizer steps, with their
    defaults (the MELD config's)."""
    config = get_config(constants.MELD)
    return {k: config[k] for k in TRAIN_KEYS}


def to_namespace(config: dict) -> SimpleNamespace:
    return SimpleNamespace(**config)
