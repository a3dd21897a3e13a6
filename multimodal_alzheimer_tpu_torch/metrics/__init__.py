"""Classification metrics (port of ``multimodal_alzheimer_tpu/metrics``)."""
