"""Deterministic seeding (reference ``pl.seed_everything`` equivalent)."""

from __future__ import annotations

import random

import numpy as np
import torch


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python, numpy and torch's global RNGs; return a CPU generator
    for explicit use (weight init, data)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return make_generator(seed)
