"""Host data: manifests and their provisioning, NIfTI I/O (native and
plain), pairing, the dataset, the loader, and the batch preprocessing on
the device."""
