"""Training core of the port: stage partition, swap schedule, failure
schedule, wall-clock model, recovery math, train state and the trainer.

The counterpart of ``repro.core``; import the modules directly
(``repro_torch.core.trainer``, ...).
"""
