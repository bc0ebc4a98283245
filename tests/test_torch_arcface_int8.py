"""The IR-50 at ``conv_impl='int8'`` (``--serve_quant int8 |
int8_static``) against ``fvt_tpu``'s ``VisualBackbone(conv_impl='int8')``
on 3 frames, the weights carried by ``from_jax.py``, on the CPU (the plain
versions of the kernels).  ``fvt_tpu``'s int8 backbone is emulated on the
CPU and slow, so its calibration forward (the 41 amaxes, the embeddings
and every block's output) runs once, jitted, in a module fixture.

* The 41 quantised convs (Cin >= 128, any stride) record their amaxes
  under ``fvt_tpu``'s ``act_scales`` paths; given ``fvt_tpu``'s input to
  each block, each amax is within 1e-6 relative of ``fvt_tpu``'s.  Run
  end to end, the amaxes agree within 7e-8 up to body5's conv1 and then
  drift apart by up to 3% (measured 2.77e-2; the gate is 5e-2): each int8
  conv amplifies the frameworks' float differences of ~1e-7 wherever a
  value lies within rounding of a quantisation step, and the next conv
  takes the moved value.
* Given ``fvt_tpu``'s input to each block, each block's output within
  1e-3 relative L2 of ``fvt_tpu``'s int8 one, where the port's float32
  block is at least 9.5e-3 away: the gate that tells int8 from float.
* The embeddings within that same drift of ``fvt_tpu``'s int8 ones:
  cosine at least 0.995 and no component 0.02 apart (measured 0.9975 and
  0.0097, |components| ~0.035 on average); each the port's own int8
  embedding at cosine above 0.97 to its float32 one (``fvt_tpu``'s
  criterion; measured 0.9983).  This end-to-end gate is no wider than
  the drift, but the drift is as wide as int8's distance from float32
  (the port's float32 embeddings are at cosine 0.9984 and max 0.0084 of
  ``fvt_tpu``'s int8 ones), so only the block gate above tells them
  apart.
* Static on the calibration batch equals dynamic bit for bit; the
  parameter tree is the float model's; the amax tree round-trips through
  ``act_scales``/``load_act_scales``; ``fused_blocks`` with int8 raises.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvt_tpu.models.arcface import BottleneckIR as JaxBlock
from fvt_tpu.models.arcface import VisualBackbone as JaxVisualBackbone
from fvt_tpu_torch.models.arcface import VisualBackbone, get_blocks_50
from fvt_tpu_torch.models.from_jax import visual_backbone_state_from_flax


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), float(np.asarray(v))


@pytest.fixture(scope='module')
def jax_int8():
    """fvt_tpu's int8 backbone on 3 frames, once: (x, its weights, the
    calibration's act_scales, the dynamic embeddings, each block's
    output)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 40, 40, 3)).astype(np.float32)
    model = JaxVisualBackbone(dtype=jnp.float32, conv_impl='int8')
    variables = jax.jit(lambda r, v: model.init(r, v, train=False))(
        jax.random.key(0), x)
    # running statistics away from 0 and 1, so that they count
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)
                      if p[-1].key == 'mean' else
                      np.asarray(a) * rng.uniform(0.5, 1.5, a.shape))
        .astype(np.float32), variables['batch_stats'])
    variables = {'params': variables['params'], 'batch_stats': stats}

    @jax.jit
    def calibrate(v, xx):
        return model.apply(
            v, xx, train=False, mutable=['act_scales', 'intermediates'],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JaxBlock))

    emb, mut = calibrate(variables, x)
    blocks = {k: np.asarray(v['__call__'][0])
              for k, v in mut['intermediates']['backbone'].items()}
    return (x, variables, jax.device_get(mut['act_scales']),
            np.asarray(emb), blocks)


@pytest.fixture(scope='module')
def port(jax_int8):
    """The port's int8 and float32 backbones on fvt_tpu's weights, the
    int8 one calibrated on the same frames: (int8 model, its dynamic
    embeddings, float32 embeddings, float32 model)."""
    x, variables, _, _, _ = jax_int8
    state = visual_backbone_state_from_flax(variables['params'],
                                            variables['batch_stats'])
    q, fp = VisualBackbone(conv_impl='int8'), VisualBackbone()
    q.load_state_dict(state)
    fp.load_state_dict(state)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        q.begin_calibration()
        emb = q(xt)
        q.end_calibration()
        return q, emb, fp(xt), fp


def test_41_convs_quantised_at_any_stride(port):
    q = port[0]
    convs = q.int8_convs()
    want = sum((in_c >= 128) + (depth >= 128)
               for in_c, depth, _ in get_blocks_50())
    assert len(convs) == want == 41
    paths = [path for path, _ in convs]
    # body3's stride-2 conv2 (128 -> 128 at 40^2) and the two stage
    # entries' conv1 are quantised; stage 1 and body3's conv1 (Cin 64) not
    assert ('backbone', 'body3', 'conv2') in paths
    assert ('backbone', 'body3', 'conv1') not in paths
    assert ('backbone', 'body7', 'conv1') in paths
    assert q.backbone.body[3].res_layer[3].stride == 2
    assert not any(p[1] in ('body0', 'body1', 'body2') for p in paths)


def test_act_scales_paths_are_fvt_tpus(jax_int8, port):
    want = dict(_leaves(jax_int8[2]))
    got = dict(_leaves(port[0].act_scales()))
    assert set(got) == set(want) and len(got) == 41


def test_each_block_records_fvt_tpus_amaxes_from_fvt_tpus_input(jax_int8,
                                                                port):
    _, _, scales, _, blocks = jax_int8
    q = port[0]
    worst = 0.0
    for i in range(3, len(get_blocks_50())):
        blk = copy.deepcopy(q.backbone.body[i])  # the fixture's stays
        x = torch.from_numpy(blocks[f'body{i - 1}'].copy()).permute(
            0, 3, 1, 2)
        for c in (blk.res_layer[1], blk.res_layer[3]):
            c.act_amax, c.calibrating = None, True
        with torch.inference_mode():
            blk(x)
        for j, conv in ((1, blk.res_layer[1]), (2, blk.res_layer[3])):
            if not conv.quantised:
                continue
            want = float(scales['backbone'][f'body{i}'][f'conv{j}']['amax'])
            got = conv.act_amax.item()
            worst = max(worst, abs(got - want) / want)
    assert worst <= 1e-6, worst


def test_each_block_gives_fvt_tpus_int8_output_from_fvt_tpus_input(
        jax_int8, port):
    """Each block of the IR-50 from body3 on (those with int8 convs), fed
    fvt_tpu's input to it, under the dynamic scale of fvt_tpu's
    calibration call: its output within 1e-3 of fvt_tpu's in relative L2
    (measured at most 2.5e-4, in the three blocks where a value lies
    within rounding of a quantisation step; the other 18 within 2e-7) and
    at least 15 blocks within 1e-6.  The port's float32 blocks fail that
    gate in every block (measured at least 9.5e-3: the int8 rounding), so
    a port that ran these convs in float would not pass."""
    blocks = jax_int8[4]
    q, fp = port[0], port[3]
    errs, fp_errs = [], []
    for i in range(3, len(get_blocks_50())):
        x = torch.from_numpy(blocks[f'body{i - 1}'].copy()).permute(
            0, 3, 1, 2)
        want = blocks[f'body{i}']
        for model, out in ((q, errs), (fp, fp_errs)):
            blk = copy.deepcopy(model.backbone.body[i])
            for c in (blk.res_layer[1], blk.res_layer[3]):
                c.act_amax = None  # the call's own scale, as fvt_tpu's
            with torch.inference_mode():
                got = blk(x).permute(0, 2, 3, 1).numpy()
            out.append(float(np.linalg.norm(got - want)
                             / np.linalg.norm(want)))
    assert max(errs) <= 1e-3, errs
    assert sum(e <= 1e-6 for e in errs) >= 15, errs
    assert min(fp_errs) > 1e-3, fp_errs


def test_end_to_end_amaxes_drift_within_quantisation(jax_int8, port):
    want = dict(_leaves(jax_int8[2]))
    got = dict(_leaves(port[0].act_scales()))
    rel = {k: abs(got[k] - want[k]) / want[k] for k in want}
    assert rel[('backbone', 'body3', 'conv2', 'amax')] <= 1e-6
    assert max(rel.values()) <= 5e-2, max(rel.values())


def test_embeddings_close_to_fvt_tpus_int8(jax_int8, port):
    want = jax_int8[3]
    _, emb, fp, _ = port
    got = emb.numpy()
    assert (got * want).sum(-1).min() >= 0.995
    assert np.abs(got - want).max() <= 0.02
    assert (emb * fp).sum(-1).min() > 0.97


def test_static_on_the_calibration_batch_is_dynamic(jax_int8, port):
    q, emb, _, _ = port
    assert q.int8_mode() == 'static'
    with torch.inference_mode():
        assert torch.equal(q(torch.from_numpy(jax_int8[0])), emb)


def test_parameter_tree_unchanged_and_scales_round_trip(port):
    q = port[0]
    fp = VisualBackbone()
    assert [(k, v.shape) for k, v in q.state_dict().items()] == \
        [(k, v.shape) for k, v in fp.state_dict().items()]
    fresh = VisualBackbone(conv_impl='int8')
    assert fresh.int8_mode() == 'dynamic'
    fresh.load_act_scales(q.act_scales())
    assert fresh.int8_mode() == 'static'
    assert dict(_leaves(fresh.act_scales())) == dict(_leaves(q.act_scales()))
    tree = q.act_scales()
    del tree['backbone']['body9']
    with pytest.raises(KeyError, match='39 amaxes for 41'):
        fresh.load_act_scales(tree)
    with pytest.raises(ValueError, match='fused block'):
        VisualBackbone(conv_impl='int8', fused_blocks=True)
