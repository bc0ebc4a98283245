"""Experiment orchestration of the port: prepare -> run / run_eval
(``fvt_tpu/experiment.py``).

Loads the per-split ``dataset_info_{ds}_{split}.pkl`` (with C-EXPR-DB's
test := valid and the challenge's train == valid == test), builds the
DataArranger, computes or reads the fold's mean/std, the model, the
loaders and the Trainer; then trains (``run``: the run loop, from an
upstream ``model.pt`` with ``--pretrained_torch_ckpt``, with checkpoints
every ``--checkpoint_every`` epochs and ``--resume``) or loads a best
model and runs the eval pass (``run_eval``; under ``--serve_quant
int8_static`` after calibrating on the loaded weights).  Everything runs
on the card unless ``device='cpu'`` is passed.  Given a ``world``
(``parallel/mesh.py``), every rank runs it data-parallel: rank 0 computes
the fold's mean/std cache while the others wait at a barrier, and only
rank 0 writes the run's files (``train/trainer.py``).
"""
from __future__ import annotations

import copy
import os
from os.path import join
from typing import Dict, Optional

from fvt_tpu_torch import constants
from fvt_tpu_torch.config import model_config as MC
from fvt_tpu_torch.data import native_store
from fvt_tpu_torch.data.arranger import DataArranger
from fvt_tpu_torch.data.dataset import ExampleBuilder
from fvt_tpu_torch.data.loader import EvalLoader, TrainLoader
from fvt_tpu_torch.models.checkpoint import load_best_model
from fvt_tpu_torch.models.registry import init_model, split_modality
from fvt_tpu_torch.parallel import mesh
from fvt_tpu_torch.preprocess.version import check
from fvt_tpu_torch.train.checkpoint import Checkpointer
from fvt_tpu_torch.train.steps import resolve_device
from fvt_tpu_torch.train.trainer import Trainer
from fvt_tpu_torch.utils.io import load_pickle, save_pickle
from fvt_tpu_torch.utils.logger import log


class Experiment:
    def __init__(self, args, device=None, world=None):
        self.args = args
        self.world = world
        self.device = world.device if world is not None \
            else resolve_device(device)
        self.dataset_name = args.dataset_name
        self.dataset_path = args.dataset_path
        self.fold_to_run = args.fold_to_run
        self.folds_dir = args.folds_dir
        self.modality = args.modality.split('+')

        self.dataset_info: Optional[dict] = None
        self.data_arranger: Optional[DataArranger] = None
        self.mean_std_dict: Optional[dict] = None
        self.trainer: Optional[Trainer] = None  # of the last run(_eval)

    # ---------------------------------------------------------------- setup
    def load_dataset_info(self) -> dict:
        ds = self.dataset_name
        feat = join(self.dataset_path, 'features')

        def load(split):
            path = join(feat, f"dataset_info_{ds}_{split}.pkl")
            info = load_pickle(path)
            msg = check(info, source=path)
            if msg is not None:
                log(f"WARNING: {msg}")
            return info

        if ds == constants.MELD:
            return {s: load(s) for s in constants.SPLITS}
        if ds == constants.C_EXPR_DB:
            info = {s: load(s) for s in (constants.TRAINSET,
                                         constants.VALIDSET)}
            info[constants.TESTSET] = copy.deepcopy(
                info[constants.VALIDSET])
            return info
        if ds == constants.C_EXPR_DB_CHALLENGE:
            info = {constants.TRAINSET: load(constants.TRAINSET)}
            info[constants.VALIDSET] = copy.deepcopy(
                info[constants.TRAINSET])
            info[constants.TESTSET] = copy.deepcopy(
                info[constants.TRAINSET])
            return info
        raise NotImplementedError(ds)

    def get_continuous_label_dim(self):
        """The classification datasets read label dim 0; VA regression
        picks by the configured emotion (upstream experiment.py:360-375)."""
        if self.args.task == constants.CLASSIFICATION:
            return [0]
        emotion = getattr(self.args, 'emotion', 'valence')
        return [1] if emotion == 'arousal' else [0]

    def get_mean_std_path(self) -> str:
        return join(self.dataset_path,
                    f"mean_std_info_fold-{self.fold_to_run}.pkl")

    def calc_mean_std(self):
        path = self.get_mean_std_path()
        if os.path.isfile(path):
            log(f"mean/std cache exists: {path}")
            return
        log(f"Computing mean/std (DS: {self.dataset_name}, "
            f"fold: {self.fold_to_run})")
        data_list = self.data_arranger.generate_partitioned_trial_list(
            window_length=self.args.window_length,
            hop_length=self.args.hop_length,
            windowing=False)
        save_pickle(self.data_arranger.calculate_mean_std(data_list), path)

    def prepare(self):
        self.dataset_info = self.load_dataset_info()
        self.data_arranger = DataArranger(
            self.args, self.dataset_info, self.dataset_path,
            self.fold_to_run, self.folds_dir)
        if self.args.calc_mean_std and (self.world is None
                                        or self.world.writer):
            self.calc_mean_std()
        mesh.barrier(self.world)  # rank 0's cache written
        self.mean_std_dict = load_pickle(self.get_mean_std_path())

    # -------------------------------------------------------------- loaders
    def init_loaders(self) -> Dict[str, object]:
        data_list = self.data_arranger.generate_partitioned_trial_list(
            window_length=self.args.window_length,
            hop_length=self.args.hop_length,
            windowing=True,
            window_eval=getattr(self.args, 'window_eval', False))

        # the native gather is built and loaded here, once: the loaders'
        # path never compiles
        native_store.ensure_built()

        builder = ExampleBuilder(
            modality=self.modality,
            window_length=self.args.window_length,
            mean_std=self.mean_std_dict,
            feature_dimension=MC.FEATURE_DIMENSION,
            task=self.args.task,
            continuous_label_dim=self.get_continuous_label_dim(),
            host_resize=getattr(self.args, 'host_resize', True))

        # beyond the core count, GIL-holding builds hurt; 2*cpu is safe as
        # the heavy steps are GIL-free native C (gather, resize)
        cpu = os.cpu_count() or 1
        loaders: Dict[str, object] = {}
        for split, data in data_list.items():
            if not data:
                raise ValueError(
                    f"split {split!r} is empty after fold filtering: no "
                    f"trial of folds_dir={self.folds_dir!r} (fold "
                    f"{self.fold_to_run}) exists in the feature store at "
                    f"{self.dataset_path!r}. Check the fold lists against "
                    f"dataset_info, or the train_p/valid_p/test_p "
                    f"subsampling.")
            if split == constants.TRAINSET:
                loaders[split] = TrainLoader(
                    data, builder,
                    batch_size=self.args.train_batch_size,
                    seed=self.args.seed,
                    num_threads=max(1, min(self.args.num_workers, 2 * cpu)),
                    bucket_quantum=(
                        getattr(self.args, 'train_bucket_quantum', 100)
                        if getattr(self.args, 'train_bucketed', False)
                        else None))
            else:
                loaders[split] = EvalLoader(
                    data, builder,
                    bucket_quantum=getattr(self.args,
                                           'eval_bucket_quantum', 100),
                    num_threads=max(1, min(self.args.num_workers, 4,
                                           2 * cpu)))
        return loaders

    @staticmethod
    def sample_batch(loaders: Dict[str, object]) -> dict:
        """One representative batch, built synchronously: the train
        loader's first, or the first loader's (``fvt_tpu``'s
        ``_sample_batch``)."""
        loader = loaders.get(constants.TRAINSET) \
            or next(iter(loaders.values()))
        return loader.sample_batch()

    def init_trainer(self) -> Trainer:
        return Trainer(init_model(self.args), vars(self.args), self.device,
                       int_to_cl=self.data_arranger.int_to_cl,
                       world=self.world)

    # ------------------------------------------------------------------ run
    def run(self) -> Trainer:
        """TRAINING: the run loop over the fold's train, val and test
        splits (upstream experiment.py:208-227)."""
        assert self.args.task == constants.CLASSIFICATION, self.args.task
        loaders = self.init_loaders()
        trainer = self.init_trainer()
        if getattr(self.args, 'pretrained_torch_ckpt', None):
            self.load_weights(trainer, self.args.pretrained_torch_ckpt)

        checkpointer = None
        every = getattr(self.args, 'checkpoint_every', 0)
        if every or getattr(self.args, 'resume', False):
            checkpointer = Checkpointer(self.args.outd, every=every or 1)
            checkpointer.allow_restore = bool(self.args.resume)

        self.trainer = trainer
        trainer.optimize(loaders[constants.TRAINSET],
                         loaders[constants.VALIDSET],
                         loaders[constants.TESTSET],
                         checkpointer=checkpointer)
        return trainer

    def load_weights(self, trainer: Trainer, path: str) -> None:
        """``fvt_tpu``'s ``model.msgpack`` or an upstream ``model.pt`` (its
        family's dead keys dropped, as ``--pretrained_torch_ckpt`` takes
        it) into the live model."""
        load_best_model(trainer.model, path,
                        split_modality(self.args.modality))
        log(f"Loaded weights from {path}")

    def run_eval(self, path_model: str):
        """EVALUATION: load a saved best model and run the eval pass over
        ``--eval_set`` (upstream experiment.py:222-269)."""
        loaders = self.init_loaders()
        trainer = self.init_trainer()
        assert os.path.isfile(path_model), path_model
        self.load_weights(trainer, path_model)
        if getattr(self.args, 'serve_quant', 'none') == 'int8_static':
            # after the real weights are loaded: the scales describe the
            # served checkpoint's activations
            trainer.calibrate_quant(self.sample_batch(loaders))

        # on the challenge dataset every split is the whole store; on the
        # others the flag picks the split
        eval_set = getattr(self.args, 'eval_set', None) or constants.TESTSET
        if eval_set == constants.TRAINSET and isinstance(
                loaders.get(constants.TRAINSET), TrainLoader):
            raise NotImplementedError(
                "--eval_set train: the train split is windowed for "
                "training, not whole-video eval; evaluate val/test, or "
                "retarget a challenge dataset (whose 'train' aliases "
                "the whole store as an eval split)")
        self.trainer = trainer
        return trainer.inference(loaders[eval_set])
