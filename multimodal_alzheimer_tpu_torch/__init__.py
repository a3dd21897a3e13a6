"""PyTorch/CUDA port of ``multimodal_alzheimer_tpu`` for NVIDIA Hopper.

Modules mirror the JAX package's paths. This package serves the MRI
classifier (``models.mri_models.anat_cnn.AnatCNN``) through
``inference.predictor.Predictor`` and ``inference.server.BatchingServer``,
and trains it through ``train.loop.Trainer`` (``train.state``,
``train.optim``, ``train.checkpoint``, ``data.pipeline.DataLoader``). Its
hand-written CUDA kernels are the per-scan quantile min-max normalisation
(``csrc/minmax_norm.cu``, wrapped by ``ops.hopper_norm``) and the
training-mode BatchNorm that ``fused_bn="full"`` selects
(``csrc/batch_norm.cu``, wrapped by ``ops.hopper_bn``). It imports ``torch``
and never ``jax``; its entry points run on the card unless the caller asks
for the CPU.
"""

__version__ = "0.2.0"
