"""The pipeline-parallel backend of the port (``Trainer(backend="spmd")``):
``spmd`` (the GPipe schedule, the training step and window, recovery as
neighbour transfers) over ``transport`` (gloo, staged through host memory on
the card).  The counterpart of ``repro.pipeline``."""
