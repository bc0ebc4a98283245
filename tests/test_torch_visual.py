"""The port's ``cnn.npy`` extractor (``fvt_tpu_torch/preprocess/visual.py``)
against ``fvt_tpu``'s, on the CPU.

* ``extract_cnn_features`` on 3 seeded 64^2 crops at batch 2 (a chunk of
  2 and a short one of 1, not padded in the port) with ``fvt_tpu``'s
  initialised ArcFace carried over by ``visual_backbone_state_from_flax``:
  within ``EMBED_RTOL`` of the largest magnitude of ``fvt_tpu``'s.
* ``extract_cnn_to_npy`` writes that once; ``backbone_from_pth`` loads an
  upstream-named state dict strictly; a backbone on another device than
  the frames is refused, and so is a run without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvt_tpu.models.arcface import VisualBackbone as FlaxVisualBackbone
from fvt_tpu.preprocess import visual as jax_visual
from fvt_tpu_torch.models.arcface import VisualBackbone
from fvt_tpu_torch.models.from_jax import visual_backbone_state_from_flax
from fvt_tpu_torch.preprocess import visual

EMBED_RTOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread_x64_off():
    n = torch.get_num_threads()
    was_x64 = bool(jax.config.jax_enable_x64)
    torch.set_num_threads(1)
    jax.config.update('jax_enable_x64', False)
    yield
    jax.config.update('jax_enable_x64', was_x64)
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def carried():
    """(video, fvt_tpu's features at batch 2, the port's backbone)."""
    model = FlaxVisualBackbone()
    variables = jax.jit(lambda r, a: model.init(r, a, train=False))(
        jax.random.key(0), jnp.zeros((1, 40, 40, 3)))
    params, stats = variables['params'], variables['batch_stats']
    video = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3),
                                              np.uint8)
    want = jax_visual.extract_cnn_features(video, params, stats, batch=2)
    backbone = VisualBackbone()
    backbone.load_state_dict(visual_backbone_state_from_flax(params, stats),
                             strict=True)
    return video, want, backbone.eval()


def test_cnn_features_match_fvt_tpu(carried, tmp_path):
    video, want, backbone = carried
    got = visual.extract_cnn_features(video, backbone, batch=2, device='cpu')
    assert got.shape == want.shape == (3, 512) and got.dtype == np.float32
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= EMBED_RTOL * scale, (
        np.abs(got - want).max(), scale)
    np.save(tmp_path / 'video.npy', video)
    visual.extract_cnn_to_npy(str(tmp_path), backbone, device='cpu')
    np.testing.assert_array_equal(np.load(tmp_path / 'cnn.npy'),
                                  visual.extract_cnn_features(
                                      video, backbone, device='cpu'))
    np.save(tmp_path / 'cnn.npy', np.zeros(1))  # present: not rewritten
    visual.extract_cnn_to_npy(str(tmp_path), backbone, device='cpu')
    assert np.load(tmp_path / 'cnn.npy').shape == (1,)


def test_backbone_from_pth_and_the_card(carried, tmp_path, monkeypatch):
    video, _, backbone = carried
    path = str(tmp_path / 'res50_ir_0.887.pth')
    torch.save(backbone.state_dict(), path)
    loaded = visual.backbone_from_pth(path, device='cpu')
    for k, v in backbone.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    torch.save({'backbone.extra': torch.zeros(1), **backbone.state_dict()},
               path)
    with pytest.raises(RuntimeError, match='Unexpected key'):
        visual.backbone_from_pth(path, device='cpu')
    with pytest.raises(ValueError, match='lies on'):
        visual.extract_cnn_features(video, VisualBackbone().to('meta'),
                                    device='cpu')
    np.save(tmp_path / 'video.npy', video)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: visual.extract_cnn_features(video, backbone),
                 lambda: visual.extract_cnn_to_npy(str(tmp_path), backbone),
                 lambda: visual.backbone_from_pth(path)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
