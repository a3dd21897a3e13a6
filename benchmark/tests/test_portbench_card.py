"""On the card (marker ``cuda``; each test looks for a card itself and
skips without one): a short run of each cell comes out correct, and the
control at the cell's own size fails its limits."""

import pytest

from benchmark.lib import compare, spec

CELLS = ["anat_r18.train.b32", "allmod_r18.train.b32",
         "allmod_r18.train_frozen.b32", "anat_r18.serve_int8.c64"]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    from benchmark import run

    env = run.Env(4100000001, 2.0, False, _card())
    result = run.execute(cell, env)
    assert result["correct"] is True
    assert result["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:3])
def test_float8_control_fails_at_full_size(cell):
    from benchmark.traffic import train

    session = train.Session(spec.Cell(cell), 4100000002, _card(), {})
    session.close()
    ref = train.reference(session)
    low = train.reference(session, numerics="fp8")
    limits = spec.Cell(cell).spec["limits"]
    assert not compare.judge(compare.train_numbers(low, ref), limits)[0]


@pytest.mark.cuda
def test_int4_control_fails_at_full_size():
    from benchmark.traffic import serve_closed

    cell = spec.Cell("anat_r18.serve_int8.c64")
    session = serve_closed.Session(cell, 4100000003, _card(), {})
    session.close()
    idx = list(range(cell.traffic["check_requests"]))
    ref = serve_closed.reference(session, idx)
    low = serve_closed.reference(session, idx, bits=4)
    assert not compare.judge(compare.serve_numbers(low, ref),
                             cell.spec["limits"])[0]
