"""The stem max pool, MaxPool3d(k=3, stride=2, pad=1), and its plain backward.

Port of ``multimodal_alzheimer_tpu/ops/maxpool.py``. The forward is the
library pool on NCDHW (JAX's is XLA's ``reduce_window``, outside any Pallas
kernel). ``max_pool3d_backward_plain`` is the function that the JAX
package's winner-offset backward (``_bwd_winner``) and its Pallas kernel
(``pallas_maxpool._bwd_kernel``) compute, with SelectAndScatter's order of
adds:

* the winner of an output window is its first offset, in row-major
  ``(od, oh, ow)`` order over the ``-inf``-padded input, where ``x == y``
  (a window holding NaN has ``y = NaN`` and no winner; a credit that lands
  in the padding is dropped);
* each input element receives the sum of ``g`` over the windows it wins,
  added in ascending output index from 0, one rounding per add in ``g``'s
  dtype.

It loops over the 27 offsets in ``(2, 1, 0)^3`` order and adds each
offset's credits into a strided slice of a padded ``dx``: for one input
element a larger offset means a smaller output index. This plain version
serves the CPU tests and the CPU path; on the card the kernel of
``ops/hopper_maxpool.py`` computes the same function.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

WINDOW, STRIDE, PAD = 3, 2, 1
NO_WINNER = WINDOW ** 3  # the winner code of a window where nothing equals y


def pool_forward(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(3, 2, 1) over the last three axes of (B, C, D, H, W)."""
    return F.max_pool3d(x, WINDOW, STRIDE, PAD)


def _offset_slices(k, out_shape):
    """Slices of the padded input that offset ``k`` of every window reads:
    output o reads padded position ``2 o + k`` along each axis."""
    return (Ellipsis,) + tuple(
        slice(kk, kk + STRIDE * (n - 1) + 1, STRIDE)
        for kk, n in zip(k, out_shape))


def winner_offsets(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """uint8 (B, C, Do, Ho, Wo): the first row-major offset of each window
    where the ``-inf``-padded input equals ``y``, or ``NO_WINNER``."""
    xp = F.pad(x, (PAD,) * 6, value=float("-inf"))
    out_shape = y.shape[-3:]
    winner = torch.full(y.shape, NO_WINNER, dtype=torch.uint8,
                        device=y.device)
    offsets = list(itertools.product(range(WINDOW), repeat=3))
    for lin in reversed(range(len(offsets))):
        hit = xp[_offset_slices(offsets[lin], out_shape)] == y
        winner = torch.where(hit, torch.tensor(lin, dtype=torch.uint8,
                                               device=y.device), winner)
    return winner


def max_pool3d_backward_plain(x: torch.Tensor, y: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """dx of MaxPool3d(3, 2, 1) with first-max winners from ``x == y``, in
    ``g``'s dtype (JAX casts g to x's; the autograd Function does too)."""
    winner = winner_offsets(x, y)
    out_shape = y.shape[-3:]
    dx_pad = torch.zeros(x.shape[:-3] + tuple(n + 2 * PAD
                                              for n in x.shape[-3:]),
                         dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for k in itertools.product(reversed(range(WINDOW)), repeat=3):
        lin = (k[0] * WINDOW + k[1]) * WINDOW + k[2]
        dx_pad[_offset_slices(k, out_shape)] += torch.where(winner == lin, g,
                                                            zero)
    return dx_pad[..., PAD:-PAD, PAD:-PAD, PAD:-PAD].contiguous()
