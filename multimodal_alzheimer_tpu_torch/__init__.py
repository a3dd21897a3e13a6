"""PyTorch/CUDA port of ``multimodal_alzheimer_tpu`` for NVIDIA Hopper.

Modules mirror the JAX package's paths. This package serves the MRI
classifier (``models.mri_models.anat_cnn.AnatCNN``) through
``inference.predictor.Predictor`` and ``inference.server.BatchingServer``,
with the per-scan quantile min-max normalisation in hand-written CUDA
kernels (``csrc/minmax_norm.cu``, wrapped by ``ops.hopper_norm``). It
imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
