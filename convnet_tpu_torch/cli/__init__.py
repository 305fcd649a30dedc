"""The port's command-line trainer: ``python -m convnet_tpu_torch.cli.main``."""
