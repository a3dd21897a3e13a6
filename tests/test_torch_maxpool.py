"""The port's stem max pool and its backward against the JAX package (CPU).

``ops/maxpool.max_pool3d_backward_plain`` is the function the Hopper kernel
K8 computes (``csrc/maxpool_bwd.cu``; the card tests hold the kernel to it).
Here it must be **bitwise** equal to ``jax.grad`` of flax ``nn.max_pool``
(XLA's SelectAndScatter) and to the Pallas kernel it replaces
(``pallas_maxpool.max_pool3d_pl`` in interpret mode), in float32 and
bfloat16, on tie-heavy inputs: ReLU zeros, constant blocks and ``-inf``
borders. NDHWC (JAX) and NCDHW (port) are converted at the boundary.

Model level, as tests/test_models.py holds the JAX options: the port's
``AnatCNN`` with ``maxpool_impl`` "sf" and "wf" (both run
``ops/hopper_maxpool.max_pool3d_pl``, the kernel's autograd Function, which
takes its plain version on the CPU) against "xla" (``F.max_pool3d``): equal
logits, gradients within rtol 1e-5, atol 1e-6 (tests/test_models.py); and
the port's "wf" against the JAX "wf" from converted weights, at the
model-parity tolerances of tests/test_torch_anat_cnn.py (logits) and
tests/test_torch_train.py (gradients).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_alzheimer_tpu.ops.maxpool import max_pool3d_wf
from multimodal_alzheimer_tpu.ops.pallas_maxpool import (
    max_pool3d_pl as jax_max_pool3d_pl,
)
from multimodal_alzheimer_tpu_torch.models.convert import flax_from_state_dict
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.ops import hopper_maxpool
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    NO_WINNER,
    max_pool3d_backward_plain,
    pool_forward,
    winner_offsets,
)
from torch_port_helpers import model_pair, run_unfused

# tests/test_pallas_maxpool.py:35-40, NDHWC: odd, even, D a multiple of the
# Pallas block, tiny.
SHAPES = [(2, 9, 11, 9, 4), (1, 8, 8, 8, 3), (2, 12, 10, 14, 8),
          (1, 5, 7, 5, 2)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KINDS = ("normal", "relu_ties", "constant_blocks", "neg_inf_border")
MODEL_SHAPE = (12, 14, 12)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_torch_anat_cnn.py
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3      # tests/test_torch_train.py
IMPL_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_models.py:236-239


def _ref_pool(x):
    return nn.max_pool(x, (3, 3, 3), strides=(2, 2, 2), padding=[(1, 1)] * 3)


def _input(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "relu_ties":
        x = np.maximum(x - 0.8, 0.0)  # ~80% exact zeros
    elif kind == "constant_blocks":
        x = (np.round(x * 2) / 2).astype(np.float32)
        x[:, : shape[1] // 2] = 1.0
    elif kind == "neg_inf_border":
        x[:, 0] = -np.inf  # whole windows of -inf: the winner is the pad
        x[:, :, :3] = -np.inf
    return x


def _ncdhw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 4, 1, 2, 3))).to(dtype)


def _ndhwc(t):
    return t.to(torch.float32).permute(0, 2, 3, 4, 1).numpy()


def _port_grad(x, w, torch_dtype):
    xt = _ncdhw(x, torch_dtype)
    y = pool_forward(xt)
    return y, max_pool3d_backward_plain(xt, y, _ncdhw(w, torch_dtype))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_equals_select_and_scatter(shape, dtype, kind):
    jax_dtype, torch_dtype = DTYPES[dtype]
    x = jnp.asarray(_input(kind, shape)).astype(jax_dtype)
    y = _ref_pool(x)
    w = jnp.asarray(np.random.default_rng(1).normal(size=y.shape)
                    .astype(np.float32)).astype(jax_dtype)
    want = jax.grad(lambda v: jnp.sum((w * _ref_pool(v))
                                      .astype(jnp.float32)))(x)
    y_port, got = _port_grad(x.astype(jnp.float32), w.astype(jnp.float32),
                             torch_dtype)
    assert got.dtype == torch_dtype and got.is_contiguous()
    np.testing.assert_array_equal(_ndhwc(y_port),
                                  np.asarray(y, np.float32))
    np.testing.assert_array_equal(_ndhwc(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("shape", [(1, 5, 7, 5, 2), (2, 9, 11, 9, 4)],
                         ids=str)
def test_plain_backward_equals_the_pallas_kernel(shape):
    """The kernel the port replaces, in the Pallas interpreter."""
    x = jnp.asarray(_input("relu_ties", shape, seed=2))
    w = jnp.asarray(np.random.default_rng(3).normal(
        size=_ref_pool(x).shape).astype(np.float32))
    want = jax.grad(lambda v: jnp.sum(w * jax_max_pool3d_pl(v, True)))(x)
    _, got = _port_grad(x, w, torch.float32)
    np.testing.assert_array_equal(_ndhwc(got), np.asarray(want))


def test_a_window_holding_nan_credits_nothing():
    """y is NaN there, so x == y never holds: the window has no winner, as
    in the JAX winner-offset backward and the Pallas kernel (XLA's
    SelectAndScatter credits another element instead, and torch's pool
    backward the NaN itself). The JAX winner-offset backward adds in
    ascending offset order, so an element credited three times or more may
    differ by an ulp: rtol 1e-6."""
    shape = (1, 5, 7, 5, 2)
    x = _input("normal", shape, seed=4)
    x[0, 2, 3, 2, 0] = np.nan
    w = np.random.default_rng(5).normal(
        size=_ref_pool(jnp.asarray(x)).shape).astype(np.float32)
    wj = jnp.asarray(w)
    want = jax.grad(lambda v: jnp.sum(wj * max_pool3d_wf(
        v, (3, 3, 3), (2, 2, 2), ((1, 1),) * 3)))(jnp.asarray(x))
    y, got = _port_grad(x, w, torch.float32)
    np.testing.assert_allclose(_ndhwc(got), np.asarray(want), rtol=1e-6,
                               atol=0)
    winners = winner_offsets(_ncdhw(x, torch.float32), y)
    nan_windows = torch.isnan(y)
    assert int(nan_windows.sum()) == 2
    assert bool((winners[nan_windows] == NO_WINNER).all())
    assert bool((winners[~nan_windows] < NO_WINNER).all())


def test_autograd_function_against_torch_pool():
    """Finite inputs, float32: the forward equals F.max_pool3d, and so does
    the gradient, bitwise: torch's CPU backward also takes the first maximum
    of each window and adds into dx in ascending output order. (Where a
    window is all -inf, torch credits its first element inside the volume,
    JAX and the port the padding, which drops it.)"""
    for kind in ("normal", "relu_ties", "constant_blocks"):
        x = _ncdhw(_input(kind, (2, 9, 11, 9, 4), seed=6), torch.float32)
        w = torch.from_numpy(np.random.default_rng(7).normal(
            size=pool_forward(x).shape).astype(np.float32))
        outs = []
        for pool in (hopper_maxpool.max_pool3d_pl,
                     lambda v: F.max_pool3d(v, 3, 2, 1)):
            xi = x.clone().requires_grad_(True)
            y = pool(xi)
            (y * w).sum().backward()
            outs.append((y.detach(), xi.grad))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
        torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    x = _ncdhw(_input("relu_ties", (1, 5, 7, 5, 2)), torch.float32)
    y = pool_forward(x)
    before = dict(hopper_maxpool.LAUNCHES)
    got = hopper_maxpool.max_pool3d_backward(x, y, torch.ones_like(y))
    torch.testing.assert_close(got, max_pool3d_backward_plain(
        x, y, torch.ones_like(y)), rtol=0, atol=0)
    assert hopper_maxpool.LAUNCHES == before  # the plain version counts none
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        hopper_maxpool.max_pool3d_backward(meta, y.to("meta"),
                                           y.to("meta"))


def _port_step_grads(model, x):
    """Train-mode logits and the gradient of sum(logits^2), as a flax
    tree."""
    model.train()
    out = model({"mri": torch.from_numpy(x)})
    (out["logits"] ** 2).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    state = model.state_dict()
    grads.update({k: v for k, v in state.items() if "running" in k})
    return out["logits"].detach().numpy(), flax_from_state_dict(
        {k: grads.get(k, v) for k, v in state.items()})["params"]


@pytest.mark.parametrize("impl", ["sf", "wf"])
def test_anat_cnn_maxpool_impl_matches_xla(impl):
    hp = {"n_classes": 3, "resnet_depth": 10}
    x = np.random.default_rng(8).random((2,) + MODEL_SHAPE).astype(
        np.float32)
    ref = AnatCNN.from_hparams(hp, generator=torch.Generator().manual_seed(0))
    alt = AnatCNN.from_hparams(hp, maxpool_impl=impl)
    alt.load_state_dict(ref.state_dict())
    assert alt.backbone.maxpool_impl == impl
    with torch.no_grad():
        ref.head.cls.bias.fill_(1.0)  # the trailing ReLU passes gradient
        alt.head.cls.bias.fill_(1.0)
    ref_logits, ref_grads = _port_step_grads(ref, x)
    alt_logits, alt_grads = _port_step_grads(alt, x)
    np.testing.assert_array_equal(alt_logits, ref_logits)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **IMPL_TOL),
                 alt_grads, ref_grads)
    assert sum(float(np.abs(g).sum())
               for g in jax.tree.leaves(alt_grads["backbone"])) > 0


def test_anat_cnn_wf_matches_jax_wf():
    hp = {"n_classes": 3, "resnet_depth": 10}
    jax_model, variables, port = model_pair(hp, MODEL_SHAPE, seed=9,
                                            maxpool_impl="wf")
    assert port.backbone.maxpool_impl == "wf"
    x = np.random.default_rng(10).random((2,) + MODEL_SHAPE).astype(
        np.float32)

    def loss(params):
        out, _ = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            {"mri": jnp.asarray(x)}, train=True, mutable=["batch_stats"])
        return jnp.sum(out["logits"] ** 2), out["logits"]

    # Without XLA's fusion pass (run_unfused): fused, the JAX "sf"/"wf" stem
    # gets another gradient on the CPU (the stem BatchNorm's differs in sign
    # from eager JAX's and from "xla"'s; ROADMAP.md, section C), while the
    # port's autograd compares the very x and y of the forward.
    (_, want_logits), want = run_unfused(
        jax.value_and_grad(loss, has_aux=True),
        jax.tree.map(jnp.asarray, variables["params"]))
    logits, got = _port_step_grads(port, x)
    np.testing.assert_allclose(logits, np.asarray(want_logits), **LOGIT_TOL)

    def close(g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max())

    jax.tree.map(close, got, want)


def test_unknown_maxpool_impl_raises():
    with pytest.raises(ValueError, match="maxpool_impl"):
        AnatCNN(n_classes=2, resnet_depth=10, maxpool_impl="bogus")


# ------------------------------------------ K8's slab walk, on the CPU --
#
# csrc/maxpool_bwd.cu runs only on the card. This walks its decomposition in
# numpy with the kernel's own index arithmetic: per plane, slabs of td output
# slices [a0, a0 + td); the staged input slices [2 a0 - 1, 2 a0 + 2 td - 1];
# winner codes for the slab's windows (27 compares) and for the halo window
# a0 + td (the 9 compares of od = 0, computed again rather than taken from
# the next slab), with the kernel's masks for taps in the padding; then dx
# of the input slices [2 a0, 2 a0 + 2 td) in 16-byte chunks counted from an
# address `head` bytes past a 16-byte boundary, each element adding its
# windows' credits in ascending output order with one rounding per add. It
# must equal the plain version bitwise, and write every element once.

# The JAX grids above and one whose D = 13 gives Do = 7: a ragged last slab
# for td = 2 and 4.
WALK_SHAPES = SHAPES + [(1, 13, 7, 6, 3)]


def _bf16_round(v):
    """float32 values rounded to the nearest bfloat16, ties to even."""
    u = np.asarray(v, np.float32).reshape(-1).view(np.uint32)
    u = u.astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return u.view(np.float32).reshape(np.shape(v))


# Bits of the 27 offsets lin = (od * 3 + oh) * 3 + ow with od, oh or ow at
# 0 or 2, as the kernel masks its taps.
K_ALL, K_OD0 = (1 << 27) - 1, 0x1FF
K_OD2, K_OH0 = K_OD0 << 18, 0x7 | 0x7 << 9 | 0x7 << 18
K_OH2, K_OW0 = K_OH0 << 6, 0x1249249
K_OW2 = K_OW0 << 2


def _walk_codes(xs, ys, a0, full_end, xi0, xi1, dims):
    """Winner codes (planes, windows) of windows [a0, a0 + n) from the
    staged slices ``xs`` (slices [xi0, xi1)) and their ``ys``, as the kernel
    makes them: every tap loaded, a tap in the padding reading a clamped
    slice or row, the element before or after the row, or a guard element
    (0 here, a tie for ReLU zeros), then masked."""
    d, h, w, oh_, ow_ = dims
    planes, n = ys.shape
    guarded = np.pad(xs, ((0, 0), (1, 1)))
    codes = np.empty((planes, n), np.int64)
    for e in range(n):
        la, rem = divmod(e, oh_ * ow_)
        b, c = divmod(rem, ow_)
        a = a0 + la
        m = ys[:, e]
        taps = K_ALL if a < full_end else K_OD0
        valid = taps
        for bad, mask in ((2 * a - 1 < 0, K_OD0), (2 * a + 1 >= d, K_OD2),
                          (2 * b - 1 < 0, K_OH0), (2 * b + 1 >= h, K_OH2),
                          (2 * c - 1 < 0, K_OW0), (2 * c + 1 >= w, K_OW2)):
            if bad:
                valid &= ~mask
        hits = np.zeros(planes, np.int64)
        for od in range(3 if taps == K_ALL else 1):
            i = min(max(2 * a - 1 + od, xi0), xi1 - 1) - xi0
            for oh in range(3):
                j = min(max(2 * b - 1 + oh, 0), h - 1)
                row = i * h * w + j * w + 2 * c - 1
                for ow in range(3):
                    hit = guarded[:, row + ow + 1] == m
                    hits |= np.where(hit, 1 << ((od * 3 + oh) * 3 + ow), 0)
        hits &= valid
        hits |= np.where(m == -np.inf, taps & ~valid, 0)
        win = np.full(planes, 27)
        for lin in range(26, -1, -1):
            win = np.where((hits >> lin) & 1, lin, win)
        codes[:, e] = win
    return codes


def _walk_credit(li, j, k, n_win, oh_, ow_, codes, gs, rnd):
    t, di = divmod(li, 2)
    u, dj = divmod(j, 2)
    v, dk = divmod(k, 2)
    acc = np.float32(0.0)
    for da in range(di + 1):
        for db in range(dj + 1):
            for dc in range(dk + 1):
                la, b, c = t + da, u + db, v + dc
                if la >= n_win or b >= oh_ or c >= ow_:
                    continue
                od = 2 - 2 * da if di else 1
                oh = 2 - 2 * db if dj else 1
                ow = 2 - 2 * dc if dk else 1
                o = (la * oh_ + b) * ow_ + c
                if codes[o] == (od * 3 + oh) * 3 + ow:
                    acc = rnd(np.float32(acc + gs[o]))
    return acc


def _k8_walk(x, y, g, td, base_head, item):
    """dx (planes, D, H, W) by K8's slabs; ``base_head`` is the byte offset
    of dx's first element past a 16-byte boundary."""
    planes, d, h, w = x.shape
    od_, oh_, ow_ = y.shape[1:]
    hw, ohw = h * w, oh_ * ow_
    rnd = _bf16_round if item == 2 else (lambda v: v)
    xf, yf, gf = (t.reshape(planes, -1) for t in (x, y, g))
    dx = np.full(x.shape, np.nan, np.float32)
    writes = np.zeros(x.shape, np.int64)
    for a0 in range(0, od_, td):
        full_end, ae = min(a0 + td, od_), min(a0 + td + 1, od_)
        n_win = ae - a0
        xi0, xi1 = max(2 * a0 - 1, 0), min(2 * a0 + 2 * td, d)
        n_dx = (min(2 * a0 + 2 * td, d) - 2 * a0) * hw
        codes = _walk_codes(xf[:, xi0 * hw:xi1 * hw], yf[:, a0 * ohw:ae * ohw],
                            a0, full_end, xi0, xi1, (d, h, w, oh_, ow_))
        gs = gf[:, a0 * ohw:ae * ohw]
        for p in range(planes):
            head = (base_head + (p * d + 2 * a0) * hw * item) % 16
            end = head + n_dx * item
            for lo in range(0, end, 16):
                start, stop = max(lo, head), min(lo + 16, end)
                li, rem = divmod((start - head) // item, hw)
                j, k = divmod(rem, w)
                for _ in range(start, stop, item):
                    dx[p, 2 * a0 + li, j, k] = _walk_credit(
                        li, j, k, n_win, oh_, ow_, codes[p], gs[p], rnd)
                    writes[p, 2 * a0 + li, j, k] += 1
                    k += 1
                    if k == w:
                        k = 0
                        j += 1
                        if j == h:
                            j = 0
                            li += 1
    assert (writes == 1).all()
    return dx


@pytest.mark.parametrize("kind", ["relu_ties", "neg_inf_border"])
@pytest.mark.parametrize("td,head", [(1, 0), (2, 4), (4, 12)],
                         ids=["td1-aligned", "td2-head4", "td4-head12"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
def test_k8_slab_walk_equals_plain(shape, dtype, td, head, kind):
    torch_dtype = DTYPES[dtype][1]
    item = torch.tensor([], dtype=torch_dtype).element_size()
    xt = _ncdhw(_input(kind, shape, seed=11), torch_dtype)
    y = pool_forward(xt)
    g = torch.from_numpy(np.random.default_rng(12).normal(
        size=y.shape).astype(np.float32)).to(torch_dtype)
    want = max_pool3d_backward_plain(xt, y, g).float().numpy()
    planes = shape[0] * shape[-1]
    got = _k8_walk(*(t.float().numpy().reshape((planes,) + t.shape[2:])
                     for t in (xt, y, g)), td, head - head % item, item)
    np.testing.assert_array_equal(got.reshape(want.shape), want)

