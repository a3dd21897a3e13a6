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

A depth window (``first``, ``depth``): for a volume whose depth is sharded
(``parallel/tp.py``), x holds the global input planes ``[first, first +
Dw)`` of a volume of global depth ``depth``, and y and g the outputs ``[o0,
o0 + Do)`` that read them, ``first = max(2 o0 - 1, 0)`` (``window_outputs``).
Only planes outside ``[0, depth)`` are padding; an interior window's first
plane is a real one (its "lead" plane) that window o0 reads at its first
depth offset. The winners and the order of adds are the global ones, for
the credits of this window's outputs; the whole volume is the window ``(0,
D)``.
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


def window_outputs(first: int, planes: int, depth: int) -> tuple:
    """``(lead, o0, do)`` of the depth window that holds global input planes
    ``[first, first + planes)`` of a volume of depth ``depth``: whether it
    holds the lead plane ``2 o0 - 1``, its first output and its number of
    outputs. Raises unless the window is one that stride-2 windows align
    with: it starts at 0 or at an odd plane and ends at ``2 (o0 + do)`` or
    at ``depth``."""
    end = first + planes
    if first < 0 or planes < 1 or end > depth:
        raise ValueError(f"planes [{first}, {end}) outside a depth of "
                         f"{depth}")
    if first and first % 2 == 0:
        raise ValueError(f"a pool window starts at plane 0 or at an odd "
                         f"plane (2 o0 - 1), not at {first}")
    lead = first % 2
    o0 = (first + lead) // 2
    if end == depth:
        do = (depth - 1) // 2 + 1 - o0
    elif end % 2 == 0:
        do = end // 2 - o0
    else:
        raise ValueError(f"a pool window ends at an even plane 2 (o0 + do) "
                         f"or at the depth {depth}, not at {end}")
    if do < 1:
        raise ValueError(f"planes [{first}, {end}) of {depth} cover no "
                         f"output window")
    return lead, o0, do


def pool_forward_window(x: torch.Tensor, first: int = 0,
                        depth=None) -> torch.Tensor:
    """The outputs of MaxPool3d(3, 2, 1) over a volume of depth ``depth``
    whose windows read the planes ``x`` holds (``[first, first + Dw)``); the
    whole volume's pool when ``depth`` is None."""
    if depth is None:
        return pool_forward(x)
    lead, _, do = window_outputs(first, x.shape[-3], depth)
    back = 2 * do + 1 - (x.shape[-3] + 1 - lead)
    xp = F.pad(x, (0, 0, 0, 0, 1 - lead, back), value=float("-inf"))
    return F.max_pool3d(xp, WINDOW, STRIDE, (0, PAD, PAD))


def _offset_slices(k, out_shape):
    """Slices of the padded input that offset ``k`` of every window reads:
    output o reads padded position ``2 o + k`` along each axis."""
    return (Ellipsis,) + tuple(
        slice(kk, kk + STRIDE * (n - 1) + 1, STRIDE)
        for kk, n in zip(k, out_shape))


def winner_offsets(x: torch.Tensor, y: torch.Tensor,
                   lead: int = 0) -> torch.Tensor:
    """uint8 (B, C, Do, Ho, Wo): the first row-major offset of each window
    where the ``-inf``-padded input equals ``y``, or ``NO_WINNER``; with
    ``lead``, x's first plane stands where the padding before the volume
    would."""
    xp = F.pad(x, (PAD,) * 4 + (PAD - lead, PAD), value=float("-inf"))
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
                              g: torch.Tensor, first: int = 0,
                              depth=None) -> torch.Tensor:
    """dx of MaxPool3d(3, 2, 1) with first-max winners from ``x == y``, in
    ``g``'s dtype (JAX casts g to x's; the autograd Function does too); of
    the depth window ``[first, first + Dw)`` of a volume of depth ``depth``
    when it is given."""
    lead = 0
    if depth is not None:
        lead, _, do = window_outputs(first, x.shape[-3], depth)
        if y.shape[-3] != do:
            raise ValueError(f"y has {y.shape[-3]} output planes; the window "
                             f"has {do}")
    winner = winner_offsets(x, y, lead)
    out_shape = y.shape[-3:]
    front = PAD - lead
    dx_pad = torch.zeros(x.shape[:-3] + (x.shape[-3] + front + PAD,)
                         + tuple(n + 2 * PAD for n in x.shape[-2:]),
                         dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for k in itertools.product(reversed(range(WINDOW)), repeat=3):
        lin = (k[0] * WINDOW + k[1]) * WINDOW + k[2]
        dx_pad[_offset_slices(k, out_shape)] += torch.where(winner == lin, g,
                                                            zero)
    return dx_pad[..., front:front + x.shape[-3], PAD:-PAD,
                  PAD:-PAD].contiguous()
