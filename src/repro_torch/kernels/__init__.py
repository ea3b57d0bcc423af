"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

* ``flash_attention`` — the flash-attention forward and backward kernels
  (``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``),
  counterparts of the TPU ``_flash_kernel``, ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``, and the autograd Function over them.
* ``stage_merge``     — CheckFree's stage merge (``csrc/stage_merge.cu``),
  counterpart of the TPU ``_merge_kernel``, every leaf of a stage at once.
* ``ssd_scan``        — the Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``),
  counterpart of the TPU ``_ssd_kernel``, with a starting and a final state.
* ``adam``            — Adam in two kernels (``csrc/adam.cu``): the per-layer
  and total sums of squares of the gradients in one pass, and the update of
  every leaf in one pass on device scalars; no TPU counterpart (XLA fuses
  the JAX optimizer).
* ``ref``             — the plain versions (CPU path and on-card oracle).
* ``ops``             — dispatch by device: CPU -> plain, CUDA -> kernel.
* ``build``           — ``nvcc`` at first use, loaded with ``ctypes``.
"""
