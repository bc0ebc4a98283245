"""``fvt_tpu_torch.tools.cv_campaign`` at 2 folds x 1 seed x 1 epoch on
the CPU: the non-separable C-EXPR-DB store of the hardness knobs (seed
300, ``tests/synth_store.py``'s store, ``tests/test_torch_run_tools.py``),
two runs of ``python -m fvt_tpu_torch.main --device cpu`` each gated on
its ``passed.txt``, aggregated by the port's ``summarize_runs`` into two
rows a run (ignore-class None and 7) and one mean +/- std group an item.
The runs take one intra-op thread each (OMP_NUM_THREADS=1).
"""
import numpy as np

from fvt_tpu_torch.tools import cv_campaign


def test_cv_campaign_two_folds_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    summary = cv_campaign.main(str(tmp_path / 'cv'), folds=2, seeds=(0,),
                               epochs=1, out_md=str(tmp_path / 'cv.md'),
                               device='cpu')
    assert len(summary['runs']) == 4
    assert sorted({r['fold'] for r in summary['runs']}) == [0, 1]
    assert sorted(g['item'] for g in summary['groups']) == ['7', 'None']
    for g in summary['groups']:
        assert g['n_runs'] == 2 and g['folds'] == [0, 1]
        assert 0.0 <= g['master_mean'] <= 1.0
        assert np.isfinite(g['master_std'])
    with open(tmp_path / 'cv.md') as f:
        md = f.read()
    assert 'Aggregated over folds/seeds (mean +/- std):' in md
    assert summary['table'] in md
