"""Utilities: seeding, devices, the path registry, soft voting, profiling
and the plots."""
