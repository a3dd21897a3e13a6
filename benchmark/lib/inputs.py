"""Everything a run feeds the program, made from ``--seed``: the weights, the
raw scans and the tabular rows.

Each is drawn from its own stream (``stream_seed(seed, name)``) with a
``torch.Generator`` on the device, in a few large calls, so the same seed
gives the same tensors and one stream does not shift another. The
reference is handed the same tensors.

Weights: every leaf of the program's ``state_dict`` by name and shape:
convolution and dense kernels N(0, 1/fan_in), their biases U(0, 0.5);
BatchNorm scales U(0.5, 1.5), shifts N(0, 0.1^2), running means N(0,
0.1^2) and running variances U(0.5, 1.5); and the leaves a configuration
names under ``weights.uniform`` uniformly in their range.

Scans: a 91x109x91 volume with an ellipsoidal brain mask covering about a
quarter of the grid (the MNI152 2 mm brain mask holds 228,483 of 902,629
voxels), a smooth intensity field of a few low-frequency waves with noise,
and the raw scan left unmasked outside the brain, as a scanner writes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# name -> (base, wave amplitude, noise, floor) of a raw modality
MODALITY = {"mri": (900.0, 200.0, 60.0, 1.0),
            "pet1451": (1.0, 0.3, 0.05, 0.01)}
WAVES = 4


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed of the stream ``name`` of run seed ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + list(name.encode())
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, name))
    return g


def _is_bn(name: str, state: dict) -> bool:
    stem = name.rsplit(".", 1)[0]
    return f"{stem}.running_var" in state


def make_weights(template: dict, seed: int, device, config: dict,
                 name: str = "weights") -> dict:
    """A state dict of ``template``'s names, shapes and dtypes drawn from
    ``seed``: one normal and one uniform draw for all leaves together. The
    configuration's ``weights.uniform`` ({leaf: [low, high]}) draws the
    named leaves uniformly instead."""
    uniform_at = config.get("weights", {}).get("uniform", {})
    g = generator(seed, name, device)
    sizes = [t.numel() for t in template.values()]
    total = sum(sizes)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for (key, ref), n in zip(template.items(), sizes):
        z = normal[at:at + n].view(ref.shape)
        u = uniform[at:at + n].view(ref.shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if not ref.is_floating_point():
            raise ValueError(f"no rule draws the leaf {key}")
        if key in uniform_at:
            lo, hi = uniform_at[key]
            v = lo + (hi - lo) * u
        elif leaf == "running_var" or (leaf == "weight"
                                     and _is_bn(key, template)):
            v = 0.5 + u
        elif leaf in ("running_mean",) or (leaf == "bias"
                                           and _is_bn(key, template)):
            v = 0.1 * z
        elif leaf == "weight":
            v = z * math.sqrt(1.0 / max(1, n // ref.shape[0]))
        elif leaf == "bias":
            v = 0.5 * u
        else:
            raise ValueError(f"no rule draws the leaf {key}")
        out[key] = v.to(ref.dtype).clone()
    return out


def brain_scans(g: torch.Generator, n: int, grid, modality: str, device):
    """(scans, masks): n raw scans of ``modality`` and their brain masks,
    float32 (n, D, H, W) on ``device``."""
    base, amp, noise, floor = MODALITY[modality]
    axes = [torch.linspace(-1.0, 1.0, s, device=device) for s in grid]
    z, y, x = torch.meshgrid(*axes, indexing="ij")
    coords = torch.stack([z, y, x])  # (3, D, H, W)
    radii = 0.74 + 0.08 * torch.rand((n, 3), generator=g, device=device)
    centre = 0.06 * (torch.rand((n, 3), generator=g, device=device) - 0.5)
    rel = (coords[None] - centre[:, :, None, None, None]) / radii[
        :, :, None, None, None]
    masks = ((rel * rel).sum(1) <= 1.0).to(torch.float32)
    freq = 0.5 + 2.5 * torch.rand((n, WAVES, 3), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((n, WAVES), generator=g, device=device)
    gain = torch.randn((n, WAVES), generator=g, device=device) / math.sqrt(
        WAVES)
    field = torch.zeros((n,) + tuple(grid), device=device)
    for w in range(WAVES):
        arg = torch.einsum("nc,cdhw->ndhw", freq[:, w], coords) * math.pi
        field += gain[:, w, None, None, None] * torch.cos(
            arg + phase[:, w, None, None, None])
    scans = base + amp * field + noise * torch.randn(
        (n,) + tuple(grid), generator=g, device=device)
    return torch.clamp(scans, min=floor), masks


def host_pool(seed: int, n: int, grid, keys, n_classes: int, device,
              name: str = "pool", chunk: int = 8, tabular: int = 9) -> dict:
    """A pool of n distinct raw samples as host numpy arrays: ``label``
    (balanced, in seeded order) and each of ``keys`` ('mri' with its
    'mri_mask', 'pet1451', 'tabular'), the volumes in float32."""
    g = generator(seed, name, device)
    order = torch.randperm(n, generator=g, device=device).cpu().numpy()
    pool = {"label": (order % n_classes).astype(np.int64)}
    for key in keys:
        if key == "tabular":
            means = torch.randn((n_classes, tabular), generator=g,
                                device=device)
            rows = means[torch.from_numpy(pool["label"]).to(device)] + \
                torch.randn((n, tabular), generator=g, device=device)
            pool["tabular"] = rows.cpu().numpy()
            continue
        scans = np.empty((n,) + tuple(grid), np.float32)
        masks = np.empty_like(scans) if key == "mri" else None
        for i in range(0, n, chunk):
            m = min(chunk, n - i)
            s, k = brain_scans(g, m, grid, key, device)
            scans[i:i + m] = s.cpu().numpy()
            if masks is not None:
                masks[i:i + m] = k.cpu().numpy()
        pool[key] = scans
        if masks is not None:
            pool["mri_mask"] = masks
    return pool


class PoolDataset:
    """An indexable dataset cycling a host pool: item i is pool row i mod
    n. With the loader unshuffled, each batch of a multiple-of-n stretch
    holds distinct rows."""

    def __init__(self, pool: dict, length: int):
        self.pool = pool
        self.n = len(pool["label"])
        self.length = length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int) -> dict:
        j = int(i) % self.n
        return {k: v[j] for k, v in self.pool.items()}
