"""fvt_tpu_torch: the PyTorch / CUDA port of fvt_tpu for an NVIDIA H100.

The LFAN serving path (``fvt_tpu_torch.serve``) runs in PyTorch with two
hand-written CUDA kernels for Hopper: the fused TCN temporal block
(``ops/tcn.py``, ``csrc/tcn_block.cu``) and the fused multimodal fusion
block (``ops/fusion.py``, ``csrc/fusion.cu``).  Each kernel has a plain
PyTorch version beside it, which its wrapper runs for tensors on the
CPU.  The package imports neither JAX nor the JAX parts of ``fvt_tpu``.
"""

__version__ = '0.1.0'
