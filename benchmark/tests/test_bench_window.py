"""The window rule on a fake clock, and K1's work on a hand-made shape."""

import pytest

from core import roofline, window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("walls,seconds,unit_s,n_units", [
    ([3.0] * 10, 10.0, 3.0, 3),       # 10 / 3: three units
    ([30.0, 30.0], 10.0, 15.0, 1),    # at least one unit
    ([4.0, 8.0, 1.0, 1.0], 10.0, 2.5, 4),  # the work is fixed, not the time
    ([2.0, 2.0], 100.0, 10.0, 2),     # the work runs out
    ([9.0] * 4, 51.0, 17.0, 3),       # 51 / 17 is 3, not 2.999...
])
def test_window_rule(walls, seconds, unit_s, n_units):
    clock = Clock()
    todo = list(walls)

    def unit(k):
        if not todo:
            return None
        clock.t += todo.pop(0)
        return {"k": k}

    win = window.run(unit, window.units_for(seconds, unit_s), clock=clock)
    assert len(win.units) == n_units
    assert win.walls == walls[:n_units]
    assert win.wall == pytest.approx(sum(walls[:n_units]))


def test_k1_work_on_a_hand_made_shape():
    class Axis:
        def __init__(self, lines, size):
            self.n_lines, self.size = lines, size

    lxc = roofline.lines_x_channels([Axis(18, 380), Axis(21, 380)])
    assert lxc == 14820
    exps, flops, nbytes = roofline.k1_work({1: 10, 2: 5}, lxc, 6)
    assert exps == 10 * 14820 + 2 * 5 * 14820
    assert flops == 5 * exps
    assert nbytes == 4 * (10 * 7 + 5 * 13)
    info = dict(sms=132, clock_hz=1.98e9)
    assert roofline.bound_s((exps, flops, nbytes), info) == pytest.approx(
        exps / (16 * 132 * 1.98e9))
