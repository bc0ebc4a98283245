"""fvt_tpu_torch: the PyTorch / CUDA port of fvt_tpu for an NVIDIA H100.

Two paths run so far.  Serving (``fvt_tpu_torch.serve`` behind
``fvt_tpu_torch.streaming``): the tri-modal LFAN in eval mode through the
fused TCN temporal block (``ops/tcn.py``, ``csrc/tcn_block.cu``) and the
fused multimodal fusion block (``ops/fusion.py``, ``csrc/fusion.cu``).
Training (``fvt_tpu_torch.train``): the LFAN on precomputed features
through the fused train-mode TCN block, forward and backward
(``ops/tcn.py``, ``csrc/tcn_block_train.cu``).  Every kernel is
hand-written CUDA C++ for Hopper and has a plain PyTorch version beside
it, which its wrapper runs for tensors on the CPU.  The package imports
neither JAX nor anything of ``fvt_tpu``: it keeps its own copies of the
modules it shares with it.
"""

__version__ = '0.2.0'
