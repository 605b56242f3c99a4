"""The control of each cell's check fails, on the card, at a size a test run
can hold: the plain reference in the program's place, computed in the
precision below the configuration's.  ``python3 port_bench/control.py``
runs the same at the cells' own sizes."""
import pytest
import torch

from port_bench.drivers import detect_drive, lio_replay
from port_bench.tests.test_bench_faults import SEED, lio_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def test_lio_control_fails(card):
    cell = lio_cell()
    g = lio_replay.control(cell, SEED, card)
    assert any(v > cell.limits[k] for k, v in g.items()), g


def test_detect_control_fails(card, det_cell):
    g = detect_drive.control(det_cell, SEED, card)
    assert any(v > det_cell.limits[k] for k, v in g.items()), g
