"""The reference held to the port's CPU path (the plain versions of its
kernels) at a size a test can hold, in float32: each configuration's
first three train steps, and the int8 serving rule.

Tolerances: the first step's loss sees only the two sides' different
orders of float32 operations (measured: within 3e-7). Its gradients see
also the port's BatchNorm kernels (``fused_bn="full"``), which take the
variance as E[x^2] - E[x]^2 in float32, as the JAX package does: where a
channel's mean dwarfs its spread (the stem over the masked background)
that loses digits (measured: the stem BN scale's gradient norm 0.2% off
float64 at seed 21, where the flax-style BatchNorm agrees to 2e-7; other
leaves within 1.1e-4). Steps two and three
follow Adam's first, nearly sign-like updates at lr 1e-3 on every weight
of anat_r18, which magnify those gaps (measured: losses within 0.0042 and
changes within 0.010 on seeds 1-3; at seed 21, after the stem's 0.2%, the
third loss 6.0% off). The int8 rule is integer arithmetic and float32
operations in one order on both sides: equal answers."""

import pytest
import torch

from benchmark.lib import compare, spec
from benchmark.tests.cpu import SIZES
from benchmark.traffic import serve_closed, train

TRAIN_CELLS = ["anat_r18.train.b32", "allmod_r18.train.b32",
               "allmod_r18.train_frozen.b32"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_reference_follows_the_ports_train_step(cell):
    session = train.Session(spec.Cell(cell), 21, torch.device("cpu"),
                            dict(SIZES[cell], dtype="float32"))
    session.close()
    ref = train.reference(session)
    prog = session.readings
    assert abs(prog["loss"][0] - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    numbers = compare.train_numbers(prog, ref)
    assert numbers["loss1_self_gap"] < 1e-5
    assert numbers["grad_gap"] < 0.01
    assert numbers["loss_gap"] < 0.1
    assert numbers["update_gap"] < 0.1


def test_reference_int8_rule_equals_the_ports():
    cell = spec.Cell("anat_r18.serve_int8.c64")
    session = serve_closed.Session(cell, 21, torch.device("cpu"),
                                   SIZES[cell.name])
    clients = session.burst(0.5)
    records = [r for r in clients.records if not isinstance(r[4], Exception)]
    session.close()
    numbers, checked = serve_closed.check(session, records, 12)
    assert checked == 12
    assert numbers == {"logit_gap": 0.0, "prob_gap": 0.0}
