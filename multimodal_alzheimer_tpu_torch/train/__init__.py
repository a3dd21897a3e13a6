"""Training: state and steps, optimizers, checkpoints, logging and the
``Trainer`` (port of ``multimodal_alzheimer_tpu/train``)."""
