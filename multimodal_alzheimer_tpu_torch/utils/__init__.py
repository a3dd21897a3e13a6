"""Seeding helpers."""
