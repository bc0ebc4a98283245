"""What each rank of ``tests/test_torch_data_parallel.py`` runs: spawned
processes import this module, which imports neither JAX nor pytest.

Every rank joins the ``gloo`` group of its environment
(``fvt_tpu_torch.parallel.mesh.spawn`` sets it) and writes what it computed
to ``<out>.<rank>``.
"""
import copy
import os
import pickle

import numpy as np
import torch

from fvt_tpu_torch import constants
from fvt_tpu_torch.config.defaults import get_config
from fvt_tpu_torch.models.models import CAN, JMT, LFAN
from fvt_tpu_torch.parallel import mesh
from fvt_tpu_torch.parallel.dp import DPTrainStep
from fvt_tpu_torch.train import optim
from fvt_tpu_torch.train.steps import TrainStep
from fvt_tpu_torch.utils import rng

STEPS = 2
ROWS = 8  # the global batch of the step cases, 4 rows a rank
FRAMES = 8


def _dump(obj, out: str) -> None:
    with open(f'{out}.{os.environ["RANK"]}', 'wb') as f:
        pickle.dump(obj, f)


def _state(model) -> dict:
    """The state_dict less the frozen backbones' parameters, which no step
    moves (their BatchNorms' running statistics stay)."""
    frozen = {k for k, _ in model.named_parameters()
              if k.startswith('spatial.')}
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k not in frozen}


def run_main(argv, out: str) -> None:
    """The training CLI in this rank, then the test split's eval pass
    again on its final weights, through the device-windowed and the
    pooled host-windowed stitch.  The group is joined here (in a spawned
    rank), so that it outlives the CLI, which joins it as it is."""
    torch.set_num_threads(1)
    from fvt_tpu_torch import main as cli
    world = mesh.join('cpu')
    exp = cli.main(argv, device='cpu')
    trainer = exp.trainer
    test = exp.init_loaders()[constants.TESTSET]
    logits = {}
    for device_windows in (True, False):
        trainer.config['eval_device_windows'] = device_windows
        logits[device_windows] = trainer.inference(test)[1]
    _dump({'losses': list(trainer.loss_tracker),
           'step_losses': list(trainer.step_losses),
           'state': _state(trainer.model), 'logits': logits}, out)
    mesh.leave(world)


def _case(name: str):
    """(model, batch, task) of one step case: seeded weights and inputs,
    dropout on."""
    g = torch.Generator().manual_seed(3)
    r = np.random.default_rng(5)
    labels = r.integers(0, 7, (ROWS, FRAMES))
    task = constants.CLASSIFICATION
    if name == 'ccc':
        task = constants.REGRESSION
        model = LFAN(('vggish', 'bert'), output_dim=1, task=task,
                     tcn_dropout=0.1, fusion_dropout=0.1, generator=g)
        streams = {'vggish': 128, 'bert': 768}
    elif name == 'can_float64':
        model = CAN(('vggish', 'bert'), output_dim=7, tcn_dropout=0.2,
                    generator=g).double()
        streams = {'vggish': 128, 'bert': 768}
    elif name == 'jmt':
        model = JMT(('video', 'vggish'), output_dim=7, tcn_dropout=0.2,
                    generator=g)
        streams = {'video': 512, 'vggish': 128}
    elif name == 'lfan_video':
        # raw face crops: the crop and flip draws, the frozen ArcFace's
        # train-mode BatchNorms and dropout
        model = LFAN(('video', 'vggish'), output_dim=7, tcn_dropout=0.1,
                     fusion_dropout=0.1, generator=g)
        streams = {'vggish': 128}
    else:
        raise ValueError(name)
    dtype = np.float64 if name == 'can_float64' else np.float32
    batch = {k: r.standard_normal((ROWS, FRAMES, d)).astype(dtype)
             for k, d in streams.items()}
    if name == 'lfan_video':
        # four frames a window: the ArcFace's train forward is the cost
        batch = {k: v[:, :4] for k, v in batch.items()}
        labels = labels[:, :4]
        batch['video'] = r.integers(0, 256, (ROWS, 4, 48, 48, 3),
                                    dtype=np.uint8)
    if task == constants.REGRESSION:
        batch[constants.EXPR] = np.tanh(batch['vggish'].mean(-1))
    else:
        batch[constants.EXPR] = labels
    return model, batch, task


def run_steps(names, out: str) -> None:
    """Each case of ``names``: STEPS steps of one process on the whole
    batch and of the DP step on this rank's rows, from the same weights
    and generators; the losses and the final states."""
    torch.set_num_threads(1)
    world = mesh.join('cpu')
    hp = optim.standardize_opt_params(get_config(constants.MELD))
    results = {}
    for name in names:
        model, batch, task = _case(name)
        single = TrainStep(copy.deepcopy(model), hp, 'cpu', task=task)
        step = DPTrainStep(model, hp, world, task=task)
        per = ROWS // world.size
        mine = {k: v[world.rank * per:(world.rank + 1) * per]
                for k, v in batch.items()}
        got = {'single': [], 'dp': []}
        for i in range(STEPS):
            gen = rng.generator(0, 'epoch0', i)
            got['single'].append(float(single(batch, gen)))
            gen = rng.generator(0, 'epoch0', i)
            got['dp'].append(float(step(mine, gen, ROWS)))
        # a batch the world size does not divide: whole on every rank
        odd = {k: v[:ROWS - 1] for k, v in batch.items()}
        got['single'].append(float(single(odd, rng.generator(0, 'odd'))))
        got['dp'].append(float(step(odd, rng.generator(0, 'odd'),
                                    ROWS - 1)))
        results[name] = dict(losses=got, single=_state(single.model),
                             dp=_state(step.model))
    _dump(results, out)
    mesh.leave(world)
