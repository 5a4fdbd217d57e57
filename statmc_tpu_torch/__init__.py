"""statmc_tpu_torch: the PyTorch/CUDA port of statmc_tpu.

The same statistics-tracking path tracer and statistical denoiser as the
JAX package beside it, on tensors, with the TPU kernels (the fused and
two-level intersectors, the filter) rewritten by hand for NVIDIA Hopper
(``csrc/``).  Importing the
package imports torch and numpy only; the CUDA kernels are built at
first use.  Entry point: ``statmc_tpu_torch.driver.load`` (on the card
unless ``device="cpu"``).
"""

__version__ = "0.1.0"
