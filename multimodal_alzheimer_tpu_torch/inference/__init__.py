"""Serving: fixed-rung predictor and the dynamic-batching server."""
