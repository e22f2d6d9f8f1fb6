"""A run with its timed path broken underneath comes out not correct:
the harness's whole run past its look for a card, on the CPU at tiny
sizes, once for each fault the cell can have; and the same run unbroken
comes out correct."""

import pytest

from portbench import run
from portbench.runners import smplx_amass_stage2 as amass
from portbench.tests.conftest import AMASS_SMALL


def _run(seed, trace=False):
    result, checks = run.run_cell("amass_s2.c16", seed, 0.0, trace,
                                  device="cpu", overrides=AMASS_SMALL)
    return run.verdict(result, checks)


def test_the_unbroken_run_is_correct():
    line = _run(2**31 + 5)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"loss0_gap", "fold3_gap", "loss_gap",
                                   "move_gap"}
    assert line["attempted"] == AMASS_SMALL["clips_per_call"]
    assert set(line["metrics"]) == {"frame_iters_per_s", "setup_s"}


def test_the_traced_run_is_correct():
    """The traced run profiles two short calls; on the CPU no device
    operation is traced, so only the readers that need none report."""
    line = _run(2**31 + 7, trace=True)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"step_mfu"}
    assert line["device"]["busy_s"] == 0.0
    assert line["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", amass.FAULTS)
def test_a_broken_run_is_not_correct(fault):
    with amass.fault(fault):
        line = _run(2**31 + 6)
    assert not line["correct"], (fault, line["checks"])


def test_move_gap_takes_the_orientation_as_a_rotation():
    """An orientation near a half turn handed back as the same rotation
    with the other sign (2 pi - angle about the flipped axis) has moved
    nowhere; its axis-angle entries have jumped by about 2 pi."""
    import math

    import torch

    axis = torch.nn.functional.normalize(torch.tensor([0.3, -0.2, 0.9]),
                                         dim=0)
    x = torch.zeros((1, 4, 72))
    x[..., 3:6] = (math.pi - 0.01) * axis
    y = x.clone()
    y[..., 3:6] = -(math.pi + 0.01) * axis
    rot = amass.part_rows(y)[1] - amass.part_rows(x)[1]
    aa = amass.part_rows(y, axis_angle=True)[1] - \
        amass.part_rows(x, axis_angle=True)[1]
    assert float(rot.abs().max()) < 1e-5
    assert float(aa.abs().max()) > 5.0
