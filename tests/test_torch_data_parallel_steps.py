"""Data-parallel train steps of the port on the CPU, two ranks over
``gloo`` (``fvt_tpu_torch.parallel.mesh.spawn``,
``tests/torch_dp_worker.py``): ``DPTrainStep`` on a rank's 4 rows against
``TrainStep`` on all 8, from the same weights and generators, dropout on,
two steps, then a 7-row batch that the world size does not divide, which
runs replicated on both ranks.

The cases: the REGRESSION task's CCC loss (a mean of per-sequence terms,
so the ranks' average is the global loss); CAN in float64, whose ``bn1``
and per-modality BatchNorms take the global moments through all-reduces;
JMT, whose final attention mixes the rows of the flattened B*T timeline,
gathered over the ranks with its gradient; a ``video`` LFAN on raw face
crops (the crop and flip draws, the frozen ArcFace's train-mode
BatchNorms and dropout).  Held: the losses and every trainable parameter
and statistic within the case's tolerance, the two ranks bit for bit
alike.

The tolerances: fp32 cases within PARAM_ATOL, two orders of magnitude
above the ~1e-7 that the other summation order gives (a mask or moment
from the wrong rows moves them by 1e-2 and more); CAN in float64 within
FLOAT64_ATOL; the video LFAN within VIDEO_ATOL (below).
"""
import pickle

import numpy as np
import pytest
import torch

from fvt_tpu_torch.parallel import mesh

import torch_dp_worker as worker

PARAM_ATOL = 1e-5
FLOAT64_ATOL = 1e-10
# the video LFAN: the frozen ArcFace's 54 train-mode BatchNorms take their
# moments in another order (the running statistics land ~1e-6 apart), and
# a pre-activation of the video TCN that close to the leaky ReLU's kink
# changes side, which moves one bias by a step of its gradient: measured
# 6.6e-5 on one element of 256 (eight frames a window), the rest within
# 1e-5
VIDEO_ATOL = 2e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('dp_steps') / 'steps.pkl')
    mesh.spawn(worker.run_steps, 2, ('ccc', 'can_float64', 'jmt',
                                     'lfan_video'), out)
    return [pickle.load(open(f'{out}.{r}', 'rb')) for r in range(2)]


@pytest.mark.parametrize('case,atol', [('ccc', PARAM_ATOL),
                                       ('can_float64', FLOAT64_ATOL),
                                       ('jmt', PARAM_ATOL),
                                       ('lfan_video', VIDEO_ATOL)])
def test_dp_step_equals_one_process(steps, case, atol):
    for r in steps:
        got = r[case]
        np.testing.assert_allclose(got['losses']['dp'],
                                   got['losses']['single'],
                                   rtol=atol, atol=atol)
        for k, want in got['single'].items():
            np.testing.assert_allclose(got['dp'][k].double().numpy(),
                                       want.double().numpy(), atol=atol,
                                       err_msg=k)
    for k, v in steps[0][case]['dp'].items():
        assert torch.equal(v, steps[1][case]['dp'][k]), k
