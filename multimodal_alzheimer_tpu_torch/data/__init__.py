"""Batch preprocessing on the device."""
