"""The frozen yardstick: the bounds chip_smoke.py published for the panel
kernel, and the launches each cell's step makes."""

import pytest

import roofline


def test_panel_bound_at_the_step_panel():
    seconds, by = roofline.panel_bound(128, 3586, 0, 8)
    assert by == "operations"
    assert seconds * 1e6 == pytest.approx(2.60, abs=0.005)


def test_panel_bound_at_the_leaf():
    seconds, by = roofline.panel_bound(64, 20257, 0, 8)
    assert by == "bytes"
    assert seconds * 1e6 == pytest.approx(6.20, abs=0.005)


@pytest.mark.parametrize("dims, solver, route, count", [
    (dict(d=512, m=514, n=3), dict(fused=True, propagate_band=None), "panel_lq", 17),
    (dict(d=10000, m=10396, n=2), dict(fused=False, propagate_band="banded"), "leaf_lq", 788),
    (dict(d=10000, m=10002, n=2), dict(fused=False, propagate_band="banded"), "leaf_lq", 782),
])
def test_step_launches(dims, solver, route, count):
    launches = roofline.step_launches(**dims, **solver, itemsize=8)
    assert {x[0] for x in launches} == {route}
    assert len(launches) == count


def test_leaf_shapes_of_the_propagate():
    launches = roofline.step_launches(d=10000, m=10396, n=2, fused=False,
                                      propagate_band="banded", itemsize=8)
    assert launches[0] == ("leaf_lq", 64, 20257, 0)
    assert launches[3] == ("leaf_lq", 64, 20257, 192)


@pytest.mark.parametrize("dims, count", [(dict(d=512, m=514), 13), (dict(d=32, m=34), 1)])
def test_init_launches(dims, count):
    launches = roofline.init_launches(**dims, itemsize=8)
    assert {x[0] for x in launches} == {"panel_lq"}
    assert len(launches) == count
    assert launches[0] == ("panel_lq", min(128, dims["m"] + 2 * dims["d"]),
                           dims["m"] + 2 * dims["d"], 0)
