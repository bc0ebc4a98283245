"""Challenge inference from a frozen serving artifact (``tools/
infer_artifact.py`` of ``fvt_tpu``): the feature store, the run's
``config.yml`` and one ``.fvtserve``, no best model.

    python -m fvt_tpu_torch.tools.infer_artifact --mode EVALUATION \\
        --fd_exp <training-run-dir> --artifact <path.fvtserve> \\
        --dataset_path <challenge-root> [--folds_dir <folds>] \\
        [--target_ds_name ...] [--device cpu] [--mesh N]

The flags are ``fvt_tpu_torch.inference_challenge``'s, plus ``--artifact``,
``--device`` (default: the card) and ``--mesh N``.  LFAN only, as in ``fvt_tpu``: its
eval contract (every built video is at least a window long, a longer one
is windowed and stitched) lets every video ride the artifact's one
``(window_batch, window)`` shape.  The window rows of all videos are
pooled into fixed batches, the last repeat-padded, and each video's
logits stitched back with ``stitch_windows_np``.  Writes what
``inference_challenge`` writes: ``pred-C-EXPR-DB-CHALLENGE/
prediction.pkl`` on the challenge dataset, and ``eval-<set>-perf.pkl``,
``pred-per-frame-eval-<set>.pkl`` and ``eval-<set>-perf.txt``.
An artifact of ``--h2d_bf16_features`` takes its feature streams as
bfloat16, rounded on the host (``utils/bf16.py``); an int8 artifact
serves through the int8 ArcFace, with its calibrated scales if
``int8_static``.  ``--mesh N`` (N >= 1) sends each pooled window batch
through ``call_sharded`` over N ranks (``parallel/serving.py``): this
process is rank 0, reads the store, stitches and writes, and N - 1
follower processes hold the artifact on the next cards (or on the CPU);
N must divide the artifact's window_batch.
"""
from __future__ import annotations

import os
import pickle as pkl
import sys
from os.path import join

import numpy as np

from fvt_tpu_torch import constants
from fvt_tpu_torch.config.parse import parse_input
from fvt_tpu_torch.data import windowing as W
from fvt_tpu_torch.data.transforms import SCALE_SIZE, center_crop_offset
from fvt_tpu_torch.experiment import Experiment
from fvt_tpu_torch.export import load_artifact, load_run_config
from fvt_tpu_torch.inference_challenge import write_eval_outputs
from fvt_tpu_torch.parallel import serving
from fvt_tpu_torch.train import metrics as M
from fvt_tpu_torch.utils import bf16
from fvt_tpu_torch.utils.logger import log


def run(args, artifact_path: str, device=None, mesh_devices: int = 0):
    """(perf, per_video, experiment); the first two as
    ``Trainer.inference`` returns them.  ``mesh_devices`` N >= 1 serves
    over N ranks (module docstring), ended before this returns."""
    if args.model_name != constants.LFAN:
        raise ValueError(f'artifact inference serves the LFAN window '
                         f'contract; a {args.model_name} evaluates whole '
                         f'videos: use inference_challenge')
    # the run's own config.yml builds an artifact without model_args
    config = load_run_config(args.fd_exp)
    if not mesh_devices:
        return _run(args, load_artifact(artifact_path, device=device,
                                        config=config), device, None)
    group = serving.start(artifact_path, mesh_devices, device, config)
    try:
        return _run(args, group.art, device, group.world)
    finally:
        group.close()


def _run(args, art, device, world):
    window, hop = int(args.window_length), int(args.hop_length)
    key = next((k for k, v in art.meta['shapes'].items()
                if v['seq_len'] == window), None)
    if key is None:
        raise KeyError(f'the artifact has no shape at seq_len == '
                       f'window_length ({window}): {art.shape_keys}')
    spec = art.meta['shapes'][key]['inputs']
    wb = art.meta['shapes'][key]['window_batch']
    if world is not None and wb % world.size:
        raise AssertionError(f'artifact window_batch {wb} must divide by '
                             f'--mesh {world.size}')

    exp = Experiment(args, device)
    exp.prepare()
    loader = exp.init_loaders()[getattr(args, 'eval_set', None)
                                or constants.TESTSET]
    precrop_to = spec[constants.VIDEO]['shape'][-2] \
        if constants.VIDEO in spec else None

    per_video, wstate, wqueue = {}, {}, []

    def dispatch(flush=False):
        while len(wqueue) >= wb or (flush and wqueue):
            take = wqueue[:wb]
            del wqueue[:wb]
            rows = take + [take[-1]] * (wb - len(take))
            inputs = {k: np.stack([wstate[t]['arrs'][k][r] for t, r in rows])
                      for k in wstate[rows[0][0]]['arrs']}
            out = (art.call(inputs) if world is None
                   else art.call_sharded(inputs, mesh=world))
            for i, (trial, r) in enumerate(rows):
                st = wstate.get(trial)
                if st is None or st['done'][r]:
                    continue  # a repeat-padding row
                st['outs'][r] = out[i]
                st['done'][r] = True
            for trial in [t for t in wstate if wstate[t]['done'].all()]:
                st = wstate.pop(trial)
                per_video[trial] = {
                    'labels': st['labels'],
                    'logits': W.stitch_windows_np(st['outs'], st['mat'],
                                                  st['true_len'])}

    for batch, trials, true_lens, _ in loader.batches(
            1, windowed_threshold=None, center_crop=precrop_to):
        labels = batch.pop(constants.EXPR)
        trial, true_len = trials[0], true_lens[0]
        v = batch.get(constants.VIDEO)
        if (v is not None and precrop_to
                and v.shape[-2] == SCALE_SIZE == v.shape[-3]):
            off = center_crop_offset(SCALE_SIZE, precrop_to)
            batch[constants.VIDEO] = np.ascontiguousarray(
                v[..., off:off + precrop_to, off:off + precrop_to, :])
        mat = W.window_index_matrix(true_len, window, hop)
        n_win = mat.shape[0]
        arrs = {}
        for k, arr in batch.items():
            # a bfloat16 spec (--h2d_bf16_features): its bits, rounded on
            # the host as fvt_tpu's ml_dtypes cast rounds
            arr = (bf16.as_bits(arr[0]) if spec[k]['dtype'] == bf16.BF16
                   else arr[0].astype(spec[k]['dtype'], copy=False))
            arrs[k] = arr[mat.reshape(-1)].reshape(
                (n_win, window) + arr.shape[1:])
        wstate[trial] = dict(
            mat=mat, true_len=true_len,
            labels=np.asarray(labels[0, :true_len]).flatten(),
            arrs=arrs, done=np.zeros(n_win, bool),
            outs=np.empty((n_win, window, art.model.output_dim),
                          np.float32))
        wqueue.extend((trial, r) for r in range(n_win))
        dispatch()
    dispatch(flush=True)
    if wstate or wqueue:
        raise RuntimeError(f'windows left undispatched: {list(wstate)}, '
                           f'{len(wqueue)}')

    want = [item[1] for item in loader.work_list]
    if set(per_video) != set(want):
        raise RuntimeError(f'videos missing: '
                           f'{sorted(set(want) - set(per_video))[:5]}')
    per_video = {trial: per_video[trial] for trial in want}
    perf = M.compute_perf(per_video, args.dataset_name,
                          args.use_other_class)

    if args.dataset_name == constants.C_EXPR_DB_CHALLENGE:
        out_inf = join(args.outd, f'pred-{constants.C_EXPR_DB_CHALLENGE}')
        os.makedirs(out_inf, exist_ok=True)
        with open(join(out_inf, 'prediction.pkl'), 'wb') as f:
            pkl.dump(per_video, f, protocol=pkl.HIGHEST_PROTOCOL)
        log(f"Dumped {constants.C_EXPR_DB_CHALLENGE} predictions at "
            f"{join(out_inf, 'prediction.pkl')}")
    return perf, per_video, exp


def _take(argv: list, flag: str):
    if flag not in argv:
        return None
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv=None, device=None):
    """Runs the CLI on ``argv``; ``device`` (or ``--device``) None is the
    card.  Returns (perf, per_video, experiment)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    artifact_path = _take(argv, '--artifact')
    if artifact_path is None:
        raise SystemExit('--artifact <path.fvtserve> is required')
    device = _take(argv, '--device') or device
    mesh = int(_take(argv, '--mesh') or 0)
    if mesh:
        serving.devices(device, mesh)  # refused before anything is read
    args = parse_input(argv)
    if args.mode != constants.EVALUATION:
        raise SystemExit(f'--mode {args.mode}: EVALUATION only')
    perf, per_video, exp = run(args, artifact_path, device, mesh)
    write_eval_outputs(args, perf, per_video, exp.data_arranger.int_to_cl)
    return perf, per_video, exp


if __name__ == '__main__':
    main()
