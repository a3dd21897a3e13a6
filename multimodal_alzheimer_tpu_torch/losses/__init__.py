"""Classification losses (port of ``multimodal_alzheimer_tpu/losses``)."""
