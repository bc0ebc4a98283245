"""Port's fusion block and MultimodalTransformerEncoder vs fvt_tpu.

The JAX side runs the Pallas fusion kernel in interpret mode; the port's
wrapper runs its plain version for tensors on the CPU.  Tolerances: fp32
on both sides, summed in another order, rtol 2e-4 / atol 2e-5 as
tests/test_serving.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.models.fusion import MultimodalTransformerEncoder as FlaxMTE
from fvt_tpu.ops.fusion_pallas import fused_multimodal_fusion
from fvt_tpu_torch.models.from_jax import fusion_state_from_flax
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.models.fusion import MultimodalTransformerEncoder
from fvt_tpu_torch.ops import fusion as port_fusion

RTOL, ATOL = 2e-4, 2e-5
MODAL_DIM, HEADS = 32, 2
CASES = [(('video', 'vggish', 'bert'), {'video': 128, 'vggish': 32,
                                        'bert': 128}),
         (('vggish', 'bert'), {'vggish': 32, 'bert': 128})]
# more modalities than four: five, and all seven with embedding sizes, at
# their TCN output widths (config/model_config.py ENCODER_DIM)
MANY = [('bert', 'vggish', 'mfcc', 'egemaps', 'cnn_res50'),
        ('video', 'bert', 'cnn_res50', 'mfcc', 'vggish', 'logmel',
         'egemaps')]


def _flax_params(mods, dims, rng):
    """A fusion param tree in fvt_tpu's layout, every leaf random (the
    init's zero biases and unit LayerNorm would hide a dropped term)."""
    e3, em = 3 * MODAL_DIM, MODAL_DIM * len(mods)

    def dense(cin, cout):
        return {'dense': {
            'kernel': rng.normal(size=(cin, cout)).astype(np.float32) * 0.2,
            'bias': rng.normal(size=(cout,)).astype(np.float32) * 0.1}}
    attn = {f'qkv_{m}': dense(dims[m], e3) for m in mods}
    attn['o_proj'] = dense(em, em)
    norm = {'scale': rng.uniform(0.5, 1.5, em).astype(np.float32),
            'bias': rng.normal(size=(em,)).astype(np.float32) * 0.1}
    return {'self_attn': attn, 'norm1': norm}


@pytest.mark.parametrize('mods,dims', CASES)
def test_fused_fusion_matches_pallas(mods, dims):
    _check_against_pallas(mods, dims)


@pytest.mark.parametrize('mods', MANY)
def test_fused_fusion_of_many_modalities_matches_pallas(mods):
    """M = 5 and M = 7, which the card runs with weights read from global
    memory: the plain version against the Pallas kernel, as for M <= 4."""
    _check_against_pallas(mods, {m: MC.ENCODER_DIM[m] for m in mods})


def test_fusion_route_keeps_the_main_path_in_shared_memory():
    """The main path's three modalities (ctot = 288, ~174 KB) stage every
    weight in shared memory, the kernel's first route; M = 5, M = 7 and
    the wide M = 4 (video, bert and cnn_res50 at 128 with mfcc: Wqkv alone
    160 KB) are above the 227 KB and read Wo, or Wo and Wqkv, from global
    memory; each route's layout fits."""
    e = MODAL_DIM
    main = [MC.ENCODER_DIM[m] for m in ('video', 'vggish', 'bert')]
    assert port_fusion.fusion_route(tuple(main), e) == 0
    assert 170 * 1024 < port_fusion.smem_bytes(main, e, 0) \
        <= port_fusion.MAX_SMEM
    wide = [MC.ENCODER_DIM[m] for m in ('video', 'bert', 'cnn_res50',
                                        'mfcc')]
    assert sum(wide) == 416 and 416 * 3 * e * 4 == 159744
    routes = {}
    for name, widths in (('wide', wide), *(
            (len(mods), [MC.ENCODER_DIM[m] for m in mods])
            for mods in MANY)):
        assert port_fusion.smem_bytes(widths, e, 0) > port_fusion.MAX_SMEM
        routes[name] = port_fusion.fusion_route(tuple(widths), e)
        assert port_fusion.smem_bytes(widths, e, routes[name]) \
            <= port_fusion.MAX_SMEM
    assert routes == {'wide': port_fusion.WO_GLOBAL,
                      5: port_fusion.WO_GLOBAL,
                      7: port_fusion.WO_GLOBAL | port_fusion.WQKV_GLOBAL}
    with pytest.raises(ValueError, match='shared memory'):
        port_fusion.fusion_route((4096,) * 2, e)


def _check_against_pallas(mods, dims):
    rng = np.random.default_rng(len(mods))
    params = _flax_params(mods, dims, rng)
    x = {m: rng.normal(size=(2, 24, dims[m])).astype(np.float32)
         for m in mods}
    want = fused_multimodal_fusion(
        {m: jnp.asarray(v) for m, v in x.items()}, params, mods, MODAL_DIM,
        HEADS, time_tile=8, interpret=True)

    attn = params['self_attn']
    got = port_fusion.fused_multimodal_fusion(
        [torch.from_numpy(x[m]) for m in mods],
        [torch.from_numpy(attn[f'qkv_{m}']['dense']['kernel']) for m in mods],
        [torch.from_numpy(attn[f'qkv_{m}']['dense']['bias']) for m in mods],
        torch.from_numpy(attn['o_proj']['dense']['kernel']),
        torch.from_numpy(attn['o_proj']['dense']['bias']),
        torch.from_numpy(params['norm1']['scale']),
        torch.from_numpy(params['norm1']['bias']),
        modal_dim=MODAL_DIM, num_heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('mods,dims', CASES)
def test_encoder_module_matches_flax(mods, dims):
    """The port's module, loaded through the bridge, against flax's
    MultimodalTransformerEncoder in eval mode."""
    rng = np.random.default_rng(7 + len(mods))
    params = _flax_params(mods, dims, rng)
    x = {m: rng.normal(size=(2, 16, dims[m])).astype(np.float32)
         for m in mods}
    flax_model = FlaxMTE(mods, dims, MODAL_DIM, HEADS, dropout=0.1)
    want = flax_model.apply({'params': params},
                            {m: jnp.asarray(v) for m, v in x.items()},
                            train=False)

    module = MultimodalTransformerEncoder(mods, dims, MODAL_DIM, HEADS)
    module.load_state_dict(fusion_state_from_flax(params, mods),
                           strict=True)
    with torch.inference_mode():
        got = module({m: torch.from_numpy(v) for m, v in x.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fusion_wrapper_refuses_a_device_without_kernel():
    x = torch.zeros(1, 2, 4, device='meta')
    w = torch.zeros(4, 3 * MODAL_DIM, device='meta')
    b = torch.zeros(3 * MODAL_DIM, device='meta')
    wo = torch.zeros(MODAL_DIM, MODAL_DIM, device='meta')
    v = torch.zeros(MODAL_DIM, device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        port_fusion.fused_multimodal_fusion(
            [x], [w], [b], wo, v, v, v, modal_dim=MODAL_DIM,
            num_heads=HEADS)
