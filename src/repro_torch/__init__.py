"""PyTorch/CUDA port of the repro package, for NVIDIA Hopper (H100).

It sits beside ``repro`` (the JAX reference) and imports nothing of it.
Layout mirrors ``repro``: ``config``, ``configs``, ``data``, ``models``,
``optim``, ``core`` (stages, schedules, recovery math, the trainer),
``recovery`` (strategies), ``kernels`` (hand-written CUDA kernels from
``csrc/`` with their plain PyTorch versions), ``launch``, plus ``tree`` for
nested dicts of tensors and ``convert`` for JAX parameter trees.
"""
