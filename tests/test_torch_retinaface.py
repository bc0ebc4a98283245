"""The port's RetinaFace-R50 (``fvt_tpu_torch/preprocess/retinaface.py``)
against ``fvt_tpu``'s, on the CPU.

* The port's keys and shapes are ``fvt_tpu``'s
  ``expected_state_dict_shapes()`` (plus PyTorch's
  ``num_batches_tracked``), and a dict of exactly those keys loads with
  ``strict=True``.
* One seeded upstream-named state dict (He-scaled convolutions, drawn
  BatchNorm statistics, so that the scores spread between 0 and 1) goes
  into the port as it is and into ``fvt_tpu`` through its
  ``port_torch_state_dict``: ``(loc, conf, ldm)`` within ``NET_RTOL`` of
  each output's largest magnitude at 128^2 and at 112^2 (not a multiple
  of 32: the FPN's upsample 4 -> 7 pins ``nearest-exact``).  ``fvt_tpu``'s
  network is jitted once a shape for the file.
* ``detect`` equals ``RetinaFaceJAX.detect`` (the same boxes, landmarks
  and scores within ``SCORE_ATOL``) at thresholds 0 and 0.9, with
  ``max_size`` the image's longest side, both loaded from the same
  ``.pth``; ``_prepare``'s resize to another ``max_size`` is within one
  level of ``fvt_tpu``'s host resize.
* The host code (priors, decode, NMS, post-processing) is ``fvt_tpu``'s:
  exactly equal on seeded inputs.
* ``retinaface_state_from_flax`` gives the state dict back bit for bit.
* The weight path rules and the refusal to run without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.preprocess import retinaface as jax_rf
from fvt_tpu_torch.models.from_jax import retinaface_state_from_flax
from fvt_tpu_torch.preprocess import retinaface as rf

NET_RTOL = 1e-4
SCORE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread_x64_off():
    n = torch.get_num_threads()
    was_x64 = bool(jax.config.jax_enable_x64)
    torch.set_num_threads(1)
    jax.config.update('jax_enable_x64', False)
    yield
    jax.config.update('jax_enable_x64', was_x64)
    torch.set_num_threads(n)


def seeded_state_dict(seed: int = 0) -> dict:
    """Upstream-named numpy arrays: convolutions He-scaled (heads at a
    third), BatchNorm scales, shifts and statistics drawn."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in jax_rf.expected_state_dict_shapes().items():
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            gain = 1 / 3 if 'Head' in k else 1.0
            sd[k] = (rng.standard_normal(shape) * gain
                     * np.sqrt(2 / fan_in)).astype(np.float32)
        elif k.endswith('running_var'):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif k.endswith('running_mean') or k.endswith('.bias'):
            sd[k] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        else:  # a BatchNorm's scale
            sd[k] = rng.uniform(0.6, 1.0, shape).astype(np.float32)
    return sd


@pytest.fixture(scope='module')
def weights():
    sd = seeded_state_dict()
    params, stats = jax_rf.port_torch_state_dict(sd)
    net = rf.RetinaFaceNet()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    return sd, {'params': params, 'batch_stats': stats}, net.eval()


@pytest.fixture(scope='module')
def jax_forward():
    model = jax_rf.RetinaFaceNet()
    return jax.jit(lambda v, x: model.apply(v, x))


def test_keys_and_shapes_are_the_contract():
    want = jax_rf.expected_state_dict_shapes()
    got = {k: tuple(v.shape) for k, v in rf.RetinaFaceNet().state_dict()
           .items() if not k.endswith('num_batches_tracked')}
    assert got == want
    assert rf.expected_state_dict_shapes() == want


@pytest.mark.parametrize('size', [128, 112])
def test_network_matches_fvt_tpu(weights, jax_forward, size):
    _, variables, net = weights
    x = np.random.default_rng(size).normal(
        size=(1, size, size, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jax_forward(variables, jnp.asarray(x))]
    with torch.inference_mode():
        got = [a.numpy() for a in net(torch.from_numpy(x))]
    n_anchors = jax_rf.prior_boxes(size, size).shape[0]
    for name, g, w, k in zip(('loc', 'conf', 'ldm'), got, want, (4, 2, 10)):
        assert g.shape == w.shape == (1, n_anchors, k), name
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= NET_RTOL * scale, (name, err, scale)
    assert np.ptp(want[1][0, :, 1]) > 0.2  # the scores spread


def test_host_code_is_fvt_tpus():
    rng = np.random.default_rng(3)
    for h, w in ((64, 64), (96, 128)):
        np.testing.assert_array_equal(rf.prior_boxes(h, w),
                                      jax_rf.prior_boxes(h, w))
    pri = rf.prior_boxes(96, 128)
    loc = rng.normal(size=(len(pri), 4)).astype(np.float32)
    ldm = rng.normal(size=(len(pri), 10)).astype(np.float32)
    boxes = rf.decode_boxes(loc, pri)
    np.testing.assert_array_equal(boxes, jax_rf.decode_boxes(loc, pri))
    lands = rf.decode_landmarks(ldm, pri)
    np.testing.assert_array_equal(lands, jax_rf.decode_landmarks(ldm, pri))
    scores = rng.uniform(size=len(pri)).astype(np.float32)
    keep = rf.nms(boxes * 128, scores, 0.4)
    assert keep == jax_rf.nms(boxes * 128, scores, 0.4) and len(keep) > 1
    got = rf.postprocess_detections(boxes * 128, lands * 128, scores, keep,
                                    27, 5, 128, 96, 80)
    want = jax_rf.postprocess_detections(boxes * 128, lands * 128, scores,
                                         keep, 27, 5, 128, 96, 80)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g['score'] == w['score']
        np.testing.assert_array_equal(g['bbox'], w['bbox'])
        np.testing.assert_array_equal(g['landmarks'], w['landmarks'])


def test_bridge_gives_the_state_dict_back(weights):
    sd, variables, _ = weights
    back = retinaface_state_from_flax(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def _same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g['bbox'], w['bbox'])
        np.testing.assert_array_equal(g['landmarks'], w['landmarks'])
        assert abs(g['score'] - w['score']) <= SCORE_ATOL


def test_detect_matches_fvt_tpu(weights, tmp_path):
    sd, _, _ = weights
    path = str(tmp_path / 'retinaface_resnet50_2020-07-20.pth')
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    img = np.random.default_rng(5).integers(0, 256, (96, 128, 3), np.uint8)
    port = rf.RetinaFaceR50(max_size=128, weights_path=path, device='cpu')
    want_det = jax_rf.RetinaFaceJAX(max_size=128, weights_path=path)
    for threshold in (0.0, 0.9):
        port.threshold = want_det.threshold = threshold
        got, want = port.detect(img), want_det.detect(img)
        if threshold == 0.0:
            assert len(want) > 3
        _same_detections(got, want)
    # the resize to another max_size: within one level of fvt_tpu's
    port.max_size = want_det.max_size = 160
    x, top, left = port._prepare(img)
    want_x, want_top, want_left = want_det._prepare(img)
    assert (top, left) == (want_top, want_left) and x.shape == (1, 160,
                                                                160, 3)
    levels = np.abs(x[0].numpy() - want_x) * rf.NORM_STD * 255
    assert levels.max() < 1 + 1e-3, levels.max()
    assert np.count_nonzero(levels > 0.5) <= 1e-3 * levels.size


def test_weight_paths_and_the_card(weights, tmp_path, monkeypatch):
    monkeypatch.setenv('FVT_RETINAFACE_WEIGHTS', str(tmp_path / 'none.pth'))
    with pytest.raises(FileNotFoundError, match='no file exists'):
        rf._default_weights_path()
    monkeypatch.delenv('FVT_RETINAFACE_WEIGHTS')
    monkeypatch.setenv('TORCH_HOME', str(tmp_path))
    assert rf._default_weights_path() is None
    with pytest.raises(FileNotFoundError, match='RetinaFace weights'):
        rf.RetinaFaceR50(device='cpu')
    hub = tmp_path / 'hub' / 'checkpoints'
    hub.mkdir(parents=True)
    sd = {k: torch.from_numpy(v) for k, v in weights[0].items()}
    torch.save({'state_dict': sd}, hub / 'retinaface_resnet50_2020-07-20.pth')
    assert rf._default_weights_path() == str(
        hub / 'retinaface_resnet50_2020-07-20.pth')
    loaded = rf.RetinaFaceR50(device='cpu').model.state_dict()
    assert torch.equal(loaded['body.conv1.weight'], sd['body.conv1.weight'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        rf.RetinaFaceR50(model=rf.RetinaFaceNet())
