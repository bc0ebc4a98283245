"""The port's 2D-FAN-4 (``fvt_tpu_torch/preprocess/fan.py``) and AU
heatmaps (``preprocess/action_units.py``) against ``fvt_tpu``'s, on the
CPU.

* The port's weight shapes are ``fvt_tpu``'s
  ``expected_state_dict_shapes()``: every listed key, each BatchNorm with
  its bias and statistics, nothing else but ``num_batches_tracked``.
* One seeded upstream-named state dict (He-scaled convolutions, drawn
  BatchNorm statistics) in the port as it is and in ``fvt_tpu`` through
  its ``port_torch_state_dict``: heatmaps within ``HM_RTOL`` of their
  largest magnitude at 64^2 (the smallest input the stride-64 network
  takes).
* ``FANLandmarks.predict`` and ``make_full_frame_landmarker`` equal
  ``fvt_tpu``'s with the same ``.npz`` weights (256^2 crops), and
  ``extract_landmarks_68_native`` with an injected detector.
* The crop and decode host code is ``fvt_tpu``'s: exactly equal.
* ``fan_state_from_flax`` gives the state dict back bit for bit.
* ``au_centers`` exactly, ``au_heatmaps`` / ``batched_au_heatmaps``
  within ``AU_ATOL``.
* The weight loaders, and the refusal to run without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.preprocess import action_units as jax_au
from fvt_tpu.preprocess import fan as jax_fan
from fvt_tpu_torch.models.from_jax import fan_state_from_flax
from fvt_tpu_torch.preprocess import action_units as au
from fvt_tpu_torch.preprocess import fan

HM_RTOL = 1e-4
AU_ATOL = 1e-5
BBOX = [40, 40, 200, 220]


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
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in jax_fan.expected_state_dict_shapes().items():
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            sd[k] = (rng.standard_normal(shape)
                     * np.sqrt(1 / fan_in)).astype(np.float32)
        elif k.endswith('.bias'):
            sd[k] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        else:  # a BatchNorm's scale, then its shift and statistics
            base = k[:-len('.weight')]
            sd[k] = rng.uniform(0.6, 1.0, shape).astype(np.float32)
            sd[f'{base}.bias'] = (rng.standard_normal(shape)
                                  * 0.1).astype(np.float32)
            sd[f'{base}.running_mean'] = (rng.standard_normal(shape)
                                          * 0.1).astype(np.float32)
            sd[f'{base}.running_var'] = rng.uniform(
                0.5, 1.5, shape).astype(np.float32)
    return sd


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    sd = seeded_state_dict()
    params, stats = jax_fan.port_torch_state_dict(sd)
    path = str(tmp_path_factory.mktemp('fan') / 'fan_sd.npz')
    np.savez(path, **sd)
    return sd, {'params': params, 'batch_stats': stats}, path


@pytest.fixture(scope='module')
def jax_forward():
    model = jax_fan.FAN()
    return jax.jit(lambda v, x: model.apply(v, x))


def face_image(seed: int = 6) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (240, 240, 3),
                                                np.uint8)


def test_weight_shapes_are_the_contract():
    want = jax_fan.expected_state_dict_shapes()
    got = {k: tuple(v.shape) for k, v in fan.FAN().state_dict().items()
           if not k.endswith('num_batches_tracked')}
    for k, shape in want.items():
        assert got[k] == shape, k
    bn = {k[:-len('.weight')] for k, s in want.items()
          if k.endswith('.weight') and len(s) == 1}
    stats = {f'{b}.{s}' for b in bn for s in ('bias', 'running_mean',
                                              'running_var')}
    assert set(got) == set(want) | stats
    assert fan.expected_state_dict_shapes() == want


def test_heatmaps_match_fvt_tpu(weights, jax_forward):
    sd, variables, _ = weights
    net = fan.FAN()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax_forward(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 68)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= HM_RTOL * scale, (
        np.abs(got - want).max(), scale)


def test_predict_matches_fvt_tpu(weights, monkeypatch):
    _, _, path = weights
    img = face_image()
    port = fan.FANLandmarks(path, device='cpu')
    monkeypatch.setenv('FVT_FAN_WEIGHTS', path)
    want_fan = jax_fan.FANLandmarks()
    got, want = port.predict(img, BBOX), want_fan.predict(img, BBOX)
    assert got.shape == (68, 2) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)

    crop = img[20:220, 30:230]
    np.testing.assert_array_equal(
        fan.make_full_frame_landmarker(path, device='cpu')(crop),
        want_fan.predict(crop, (0, 0, 200, 200)))

    class Detector:
        def detect(self, im):
            return [{'bbox': np.array(BBOX, float), 'score': 1.0,
                     'landmarks': np.zeros((5, 2), np.float32)}]

    np.testing.assert_array_equal(
        fan.extract_landmarks_68_native(img, Detector(), port), want)


def test_host_code_is_fvt_tpus():
    rng = np.random.default_rng(2)
    for bbox in (BBOX, [-10.5, 3.0, 90.0, 130.0]):
        center, scale = fan.bbox_to_center_scale(bbox)
        want_c, want_s = jax_fan.bbox_to_center_scale(bbox)
        np.testing.assert_array_equal(center, want_c)
        assert scale == want_s
        np.testing.assert_array_equal(
            fan._transform_matrix(center, scale, 256),
            jax_fan._transform_matrix(center, scale, 256))
        for inv in (False, True):
            np.testing.assert_array_equal(
                fan.transform_point([17.3, 40.9], center, scale, 64, inv),
                jax_fan.transform_point([17.3, 40.9], center, scale, 64,
                                        inv))
        img = face_image(3).astype(np.float32)
        np.testing.assert_array_equal(
            fan.crop_face(img, center, scale),
            jax_fan.crop_face(img, center, scale))
        hm = rng.normal(size=(64, 64, 68)).astype(np.float32)
        hm[0, :, :3] += 10  # peaks on the border: no sub-pixel shift
        np.testing.assert_array_equal(
            fan.decode_heatmaps(hm, center, scale),
            jax_fan.decode_heatmaps(hm, center, scale))
    small = rng.uniform(0, 255, (37, 53, 3)).astype(np.float32)
    np.testing.assert_array_equal(fan._resize_bilinear(small, 256, 200),
                                  jax_fan._resize_bilinear(small, 256, 200))


def test_bridge_gives_the_state_dict_back(weights):
    sd, variables, _ = weights
    back = fan_state_from_flax(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_au_heatmaps_match_fvt_tpu():
    rng = np.random.default_rng(4)
    lms = (rng.uniform(60, 200, (3, 68, 2))).astype(np.float32)
    for lm in lms:
        got, want = au.au_centers(lm), jax_au.au_centers(lm)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got = au.au_heatmaps(lms[0], image_size=64, device='cpu')
    want = jax_au.au_heatmaps(lms[0], image_size=64)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == (64, 64)
        assert np.abs(got[k] - want[k]).max() <= AU_ATOL, k
    got = au.batched_au_heatmaps(lms, image_size=48, device='cpu')
    want = jax_au.batched_au_heatmaps(lms, image_size=48)
    assert got.shape == want.shape == (3, 8, 48, 48)
    assert np.abs(got - want).max() <= AU_ATOL


def test_loaders_and_the_card(weights, tmp_path, monkeypatch):
    sd, _, path = weights
    # a plain state-dict file and a TorchScript archive load the same
    net = fan.FAN()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    torch.save(net.state_dict(), tmp_path / 'sd.pth')
    torch.jit.save(torch.jit.trace(net.eval(), torch.zeros(1, 64, 64, 3)),
                   str(tmp_path / "fan.zip"))
    for p in ('sd.pth', 'fan.zip'):
        got = fan.FANLandmarks.load_weights(str(tmp_path / p))
        assert torch.equal(got['m3.b1_4.conv1.weight'],
                           torch.from_numpy(sd['m3.b1_4.conv1.weight']))
    monkeypatch.setenv('FVT_FAN_WEIGHTS', str(tmp_path / 'none.zip'))
    with pytest.raises(FileNotFoundError, match='no file exists'):
        fan.FANLandmarks(device='cpu')
    monkeypatch.delenv('FVT_FAN_WEIGHTS')
    monkeypatch.setenv('TORCH_HOME', str(tmp_path))
    with pytest.raises(NotImplementedError, match='2DFAN4 weights'):
        fan.FANLandmarks(device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: fan.FANLandmarks(path),
                 lambda: fan.make_full_frame_landmarker(path),
                 lambda: au.au_heatmaps(np.zeros((68, 2), np.float32) + 5),
                 lambda: au.batched_au_heatmaps(np.zeros((1, 68, 2)) + 5)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
