"""Host data: manifests, NIfTI I/O, pairing, the dataset, the loader, and
the batch preprocessing on the device."""
