"""statmc_tpu_torch: the PyTorch/CUDA port of statmc_tpu.

The same statistics-tracking path tracer and statistical denoiser as the
JAX package beside it, on tensors, with the two TPU kernels of the main
path rewritten by hand for NVIDIA Hopper (``csrc/``).  Importing the
package imports torch and numpy only; the CUDA kernels are built at
first use.  Entry point: ``statmc_tpu_torch.driver.load``.
"""

__version__ = "0.1.0"
