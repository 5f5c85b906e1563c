"""The port's command line: ``python -m open_simulator_tpu_torch.cli apply``."""
