"""K10's autograd Function and its rule on the CPU (ops/narrow_conv.py).

On the CPU the Function runs its plain versions, ``F.conv3d`` and
``aten.convolution_backward``: what autograd computes for ``F.conv3d``, so
the forward and all three gradients equal the library's bit for bit. The
rule is a table over the convolutions of the two benchmarked models: the
PET towers' 1 -> 8 and 8 -> 16 blocks taken in bfloat16 on the card, no
ResNet conv and no float32 conv. The kernels themselves run on the card only
(tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models import layers
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.ops import narrow_conv
from multimodal_alzheimer_tpu_torch.tools.cases import (
    TAB_HPARAMS,
    stage3_model,
)
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from torch_threads import torch_threads  # noqa: F401 (autouse)

CUDA = torch.device("cuda")
# (C_in, C_out, k): the PET blocks at their defaults, and early fusion's
# two-channel first block
CONV_SHAPES = [(1, 8, 5), (8, 16, 5), (16, 32, 3), (32, 64, 3), (2, 8, 5)]


def _operands(cin, cout, k, seed, grid=(12, 14, 12), batch=2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, cin) + grid, generator=gen)
    w = torch.randn((cout, cin, k, k, k), generator=gen) / (cin * k ** 3) ** 0.5
    b = torch.rand(cout, generator=gen)
    return [t.to(torch.bfloat16).requires_grad_() for t in (x, w, b)]


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_plain_path_equals_conv3d(shape, with_bias):
    """Forward, dx, dw and db of the Function's plain path equal
    F.conv3d's under autograd, bit for bit."""
    x, w, b = _operands(*shape, seed=sum(shape))
    b = b if with_bias else None
    leaves = [t for t in (x, w, b) if t is not None]
    got = narrow_conv.conv3d(x, w, b)
    want = F.conv3d(x, w, b, padding="same")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    dy = dy.to(torch.bfloat16)
    for g, h in zip(torch.autograd.grad(got, leaves, dy),
                    torch.autograd.grad(want, leaves, dy)):
        assert g.dtype == h.dtype and torch.equal(g, h)


def test_plain_path_skips_the_input_gradient():
    """With x needing no gradient the Function returns none for it, and
    the weight gradient equals the library's."""
    x, w, b = _operands(1, 8, 5, seed=4)
    x = x.detach()
    y = narrow_conv.conv3d(x, w, b)
    dw, db = torch.autograd.grad(y.float().square().sum(), (w, b))
    want = torch.autograd.grad(
        F.conv3d(x, w, b, padding=2).float().square().sum(), (w, b))
    assert torch.equal(dw, want[0]) and torch.equal(db, want[1])


@pytest.mark.parametrize("case,error", [
    ({"stride": 2}, ValueError),
    ({"groups": 2}, ValueError),
    ({"dilation": 2}, ValueError),
    ({"padding": 0}, ValueError),
    ({"dtype": torch.float32}, TypeError),
    ({"dtype": torch.float16}, TypeError),
    ({"kernel": 4}, ValueError),
], ids=["stride-2", "groups-2", "dilation-2", "valid-padding", "float32",
        "float16", "even-kernel"])
def test_wrapper_refuses_what_k10_does_not_compute(case, error):
    cin = 8
    k = case.get("kernel", 5)
    dtype = case.get("dtype", torch.bfloat16)
    x = torch.zeros((1, cin, 6, 6, 6), dtype=dtype)
    w = torch.zeros((16, cin // case.get("groups", 1), k, k, k), dtype=dtype)
    kw = {key: case[key] for key in ("stride", "groups", "dilation",
                                     "padding") if key in case}
    with pytest.raises(error):
        narrow_conv.conv3d(x, w, None, **kw)


def _convs(model):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, torch.nn.Conv3d)]


def _taken(model, dtype, input_grad=False) -> list:
    return [name for name, m in _convs(model) if narrow_conv.rule(
        m.in_channels, m.out_channels, m.kernel_size, m.stride, m.dilation,
        m.padding, m.groups, dtype, CUDA, input_grad)]


@pytest.fixture(scope="module")
def models():
    """The benchmark's two models at full width, their weights left
    undrawn (the rule reads shapes alone)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.init, "trunc_normal_", lambda t, *a, **k: t)
        return {"anat": AnatCNN(n_classes=3, resnet_depth=18, dilated=True,
                                dtype=torch.bfloat16),
                "allmod": stage3_model(
                    torch.bfloat16, 1e-5, dict(TAB_HPARAMS,
                                               feature_mean=np.zeros(9),
                                               feature_std=np.ones(9)))}


def test_rule_takes_the_pet_blocks_alone(models):
    """Every conv of the stage-3 model and of the flagship: the PET towers'
    block_0 (1 -> 8) and block_1 (8 -> 16) taken in bfloat16 on the card,
    every ResNet-18 conv (the stride-2 stem, the 64-channel and wider
    convs) and the PET blocks 2-3 left to F.conv3d; none in float32 or on
    the CPU; block_0 not where its input needs a gradient (no 8 -> 1
    kernel)."""
    allmod = models["allmod"]
    taken = _taken(allmod, torch.bfloat16)
    pet = sorted(name for name, _ in _convs(allmod)
                 if ".convs.block_0." in name or ".convs.block_1." in name)
    assert len(pet) == 4 and sorted(taken) == pet
    resnets = [name for name, m in _convs(allmod) if ".convs." not in name]
    assert len(resnets) == 2 * 20 and not set(resnets) & set(taken)
    assert _taken(models["anat"], torch.bfloat16) == []
    for model in models.values():
        assert _taken(model, torch.float32) == []
    assert not any(narrow_conv.rule(
        m.in_channels, m.out_channels, m.kernel_size, m.stride, m.dilation,
        m.padding, m.groups, torch.bfloat16, torch.device("cpu"))
        for _, m in _convs(allmod))
    with_grad = _taken(allmod, torch.bfloat16, input_grad=True)
    assert sorted(with_grad) == [n for n in pet if ".block_1." in n]


@pytest.mark.parametrize("cin,padding_mode,needs_grad,grad_mode,taken", [
    (1, "zeros", False, True, True),
    (1, "zeros", True, True, False),  # no 8 -> 1 input-gradient kernel
    (1, "zeros", True, False, True),  # under no_grad nothing asks for it
    (8, "zeros", True, True, True),
    (8, "reflect", False, True, False),
    (16, "zeros", False, True, False),
], ids=["block0", "block0-input-grad", "block0-no-grad-mode", "block1",
        "block1-reflect", "16-channels"])
def test_takes_reads_the_module_and_its_input(monkeypatch, cin, padding_mode,
                                              needs_grad, grad_mode, taken):
    """``takes`` passes the module's properties, its input's dtype and
    device and whether autograd will ask for the input's gradient to
    ``rule`` (told here that the input is on the card), and refuses any
    padding but zeros."""
    rule = narrow_conv.rule
    monkeypatch.setattr(narrow_conv, "rule", lambda *a: rule(
        *a[:8], CUDA, *a[9:]))
    conv = torch.nn.Conv3d(cin, 2 * cin if cin > 1 else 8, 5,
                           padding="same", padding_mode=padding_mode)
    x = torch.zeros((1, cin, 6, 6, 6), dtype=torch.bfloat16,
                    requires_grad=needs_grad)
    with torch.set_grad_enabled(grad_mode):
        assert narrow_conv.takes(conv, x) is taken
    assert not narrow_conv.takes(conv, x.float())


def _pet_step(route: bool, monkeypatch):
    """One Adam step of a bfloat16 SmallPETCNN on the CPU, its convs
    through K10's Function (``route``: the real ``takes``, its rule told the
    tensors are on the card) or the parent's F.conv3d; the loss, the updated
    parameters and the rule's answers."""
    calls = []
    if route:
        rule = narrow_conv.rule

        def on_the_card(cin, cout, kernel, stride, dilation, padding, groups,
                        dtype, device, input_grad=False):
            calls.append(rule(cin, cout, kernel, stride, dilation, padding,
                              groups, dtype, CUDA, input_grad))
            return calls[-1]
        monkeypatch.setattr(narrow_conv, "rule", on_the_card)
    model = SmallPETCNN(2, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    hp = {"n_classes": 2, "loss_class_weights": [0.5, 0.5]}
    step = make_train_step(model, make_criterion(hp), optimizer, None)
    rng = np.random.default_rng(1)
    batch = {"pet1451": torch.from_numpy(
        rng.random((2, 16, 18, 16), dtype=np.float32)),
        "label": torch.tensor([0, 1])}
    _, aux = step(TrainState(model, optimizer), batch)
    monkeypatch.undo()
    return aux["loss"], dict(model.named_parameters()), calls


def test_small_pet_cnn_step_equals_the_parents(monkeypatch):
    """A bfloat16 SmallPETCNN train step with its 1 -> 8 and 8 -> 16 convs
    through the Function equals the step through F.conv3d, loss and every
    updated parameter bit for bit."""
    loss, params, calls = _pet_step(True, monkeypatch)
    want_loss, want, _ = _pet_step(False, monkeypatch)
    assert calls == [True, True, False, False]  # blocks 0-1 taken
    assert float(loss) == float(want_loss)
    for name, p in params.items():
        assert torch.equal(p, want[name]), name


def test_conv3d_module_routes_by_the_rule(monkeypatch):
    """models/layers.Conv3d calls the Function exactly where ``takes``
    says, with the module's own stride, padding, dilation and groups."""
    seen = []
    monkeypatch.setattr(narrow_conv, "takes",
                        lambda conv, x: conv.out_channels == 8)
    monkeypatch.setattr(narrow_conv, "conv3d",
                        lambda *a: seen.append(a[3:]) or F.conv3d(
                            a[0], a[1], a[2], padding="same"))
    x = torch.randn(1, 1, 6, 6, 6)
    for cout in (8, 16):
        layers.Conv3d(1, cout, 5, padding="same")(x)
    assert seen == [((1, 1, 1), "same", (1, 1, 1), 1)]
