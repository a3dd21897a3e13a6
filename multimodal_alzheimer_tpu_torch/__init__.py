"""PyTorch/CUDA port of ``multimodal_alzheimer_tpu`` for NVIDIA Hopper.

Modules mirror the JAX package's paths. This package serves the MRI
classifier (``models.mri_models.anat_cnn.AnatCNN``) through
``inference.predictor.Predictor`` and ``inference.server.BatchingServer``,
trains it through ``train.loop.Trainer`` (``train.state``, ``train.optim``,
``train.checkpoint``, ``data.pipeline.DataLoader``), and runs its entry
points from NIfTI files on disk: ``models.mri_models.train_anat_cnn``
(``train.driver``, ``data.dataset.MultiModalDataset``) and
``inference.test_anat_cnn`` (``inference.harness``). Its hand-written CUDA
kernels are the per-scan quantile min-max normalisation
(``csrc/minmax_norm.cu``) and z-score (``csrc/zscore_norm.cu``), both
wrapped by ``ops.hopper_norm``, and the training-mode BatchNorm that
``fused_bn="full"`` selects (``csrc/batch_norm.cu``, wrapped by
``ops.hopper_bn``). ``parallel`` runs these paths data-parallel over
``torch.distributed`` (``mesh=``). It imports ``torch`` and never ``jax``,
nor pandas, yaml or a plotting package at module level; its entry points
run on the card unless the caller asks for the CPU.
"""

__version__ = "0.3.0"
