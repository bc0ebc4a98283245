"""What each rank of ``tests/test_torch_sharded_serving.py``'s library
checks runs: spawned processes import this module, which imports neither
JAX nor pytest.

Every rank joins the ``gloo`` group of its environment
(``fvt_tpu_torch.parallel.mesh.spawn`` sets it) and loads each case's
artifact on the CPU.  Rank 0 calls ``call_sharded`` (and the single
``call``) on each case's batch, then stops the followers; rank 1 follows
each artifact in turn.  Each rank writes what it saw to ``<out>.<rank>``:
the logits, and the scale of every dynamic int8 quantisation.
"""
import os
import pickle

import torch

from fvt_tpu_torch.export import load_artifact
from fvt_tpu_torch.ops import quant
from fvt_tpu_torch.parallel import mesh, serving


def _record_scales() -> list:
    """Every per-tensor scale ``quant.quantize_int8`` returns, in call
    order, from here on."""
    scales = []
    plain = quant.quantize_int8

    def recording(x, x_scale=None, prologue=None):
        out = plain(x, x_scale, prologue)
        scales.append(out[1].clone())
        return out

    quant.quantize_int8 = recording
    return scales


def run_cases(cases: dict, out: str) -> None:
    """``cases``: {name: (artifact path, run config or None, batch, length
    or None, indivisible batch or None)}.  The single call is made where
    the case has no length (an int8 case's scales are held against it)."""
    torch.set_num_threads(1)
    world = mesh.join('cpu')
    scales = _record_scales()
    got = {}
    for name, (path, config, batch, length, odd) in cases.items():
        art = load_artifact(path, device='cpu', config=config)
        del scales[:]
        if world.rank:
            got[name] = {'calls': serving.follow(art, world),
                         'scales': list(scales)}
            continue
        res = {'sharded': art.call_sharded(batch, mesh=world, length=length)}
        res['sharded_scales'] = list(scales)
        if length is None:
            del scales[:]
            res['single'] = art.call(batch)
            res['single_scales'] = list(scales)
        if odd is not None:
            try:
                art.call_sharded(odd, mesh=world)
            except AssertionError as e:
                res['odd'] = str(e)
        art.stop_followers(world)
        got[name] = res
    with open(f'{out}.{os.environ["RANK"]}', 'wb') as f:
        pickle.dump(got, f)
    mesh.leave(world)
