"""Training engine: loss, meters and the trainer (counterpart of
convnet_tpu/train)."""
