"""The multi-device checks of ``__graft_entry__`` (sharded == single-device
ICP, BA, pose graph, train step and map-sharded SLAM) on four of the
virtual CPU devices; ``chip_smoke.py --four`` runs the same checks on
four GPUs."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as g  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    return g.multichip_mesh(4)


@pytest.mark.parametrize("check", g.MULTICHIP_CHECKS, ids=lambda c: c.__name__)
def test_multichip_check(check, mesh):
    line = check(mesh)
    assert not line.startswith("skipped:"), line
