"""CAN on ``logmel+bert``: the port against fvt_tpu, on the CPU, by the
checks and at the tolerances of ``tests/test_torch_logmel.py`` (eval
logits; one SGD step in float32 and one ADAM step in float64), apart so
that neither file runs long on one worker."""
import pytest
import torch

from test_torch_logmel import check_eval, check_step


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread, as ``tests/test_torch_logmel.py`` pins it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_eval_logits_are_fvt_tpus():
    check_eval('CAN')


@pytest.mark.parametrize('optimizer_name', ['SGD', 'ADAM'])
def test_one_step_in_lockstep(optimizer_name):
    check_step('CAN', optimizer_name)
