"""MRI-only classifiers."""
