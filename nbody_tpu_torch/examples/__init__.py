"""Runnable examples of the port: ``python -m nbody_tpu_torch.examples.<name>``."""
