"""Default training config of the port: the keys of
``fvt_tpu/config/defaults.py`` that the ported trainer reads, with that
file's values (``tests/test_torch_copies.py`` holds them equal).  The
rest of the config (paths, data, eval and serving knobs) comes with the
CLIs.
"""
from __future__ import annotations

from fvt_tpu_torch import constants


def get_train_config() -> dict:
    return {
        'seed': 0,
        'task': constants.CLASSIFICATION,
        'num_epochs': 100,
        'min_num_epochs': 5,
        'window_length': 300,
        'hop_length': 200,
        'train_batch_size': 16,
        'nan_guard': False,

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
        'opt__coef': 0.5,
        'opt__gamma': 0.1,
        'opt__step_size': 40,
        'opt__min_lr': 1e-7,
        'opt__t_max': 100,
        'opt__mode': constants.MIN_MODE,
        'opt__factor': 0.5,
        'opt__patience': 10,
        'opt__milestone': '0',
    }
