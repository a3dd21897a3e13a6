"""Measurement scripts for the port, run on a machine with an NVIDIA GPU."""
