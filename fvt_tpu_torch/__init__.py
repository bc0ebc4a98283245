"""fvt_tpu_torch: the PyTorch / CUDA port of fvt_tpu for an NVIDIA H100.

Three paths run.  Challenge inference
(``python -m fvt_tpu_torch.inference_challenge``): a finished run's
``config.yml`` and best model (``model.msgpack`` of ``fvt_tpu`` or an
upstream ``model.pt``) over an on-disk feature store, through the
threaded loaders (``data/``), ``Trainer.inference`` and the metrics, to
``prediction.pkl`` and the perf artifacts.  Serving
(``fvt_tpu_torch.serve`` behind ``fvt_tpu_torch.streaming``).  Both run
the model in eval mode through the fused TCN temporal block
(``ops/tcn.py``, ``csrc/tcn_block_tf32x3.cu``) and, for LFAN, the fused
multimodal fusion block (``ops/fusion.py``, ``csrc/fusion_tf32x3.cu``).
Training (``python -m fvt_tpu_torch.main``, ``fvt_tpu_torch.train``):
LFAN, CAN, JMT or MT, on features or on video through the frozen
ArcFace, through the fused train-mode TCN block, forward and backward
(``ops/tcn.py``, ``csrc/tcn_block_train_tf32x3.cu``), on one GPU or
data-parallel over several (``--data_parallel``, ``parallel/``).  The
run tools (``tools/``: ``quickstart``, ``cv_campaign``,
``validate_store``, ``summarize_runs``, ``port_checkpoint``) drive these
paths from the command line.  Every kernel is hand-written CUDA
C++ for Hopper and has a plain PyTorch version beside it, which its
wrapper runs for tensors on the CPU.  The package imports neither JAX,
flax, PyYAML, msgpack nor anything of ``fvt_tpu``: it keeps its own
copies of the modules it shares with it, and reads YAML and flax's
msgpack with its own readers.
"""

__version__ = '0.3.0'
