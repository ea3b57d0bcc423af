"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

* ``flash_attention`` — the forward flash-attention kernel
  (``csrc/flash_attention_fwd.cu``), counterpart of the TPU ``_flash_kernel``.
* ``ref``             — the plain versions (CPU path and on-card oracle).
* ``ops``             — dispatch by device: CPU -> plain, CUDA -> kernel.
* ``build``           — ``nvcc`` at first use, loaded with ``ctypes``.
"""
