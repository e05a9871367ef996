"""``act_tpu_torch.profiling.device_ms``: a window's time counts only when
each kernel was recorded a whole number of times per call (profiler windows
replaced by lists of fake records, so this runs on the CPU)."""
from types import SimpleNamespace

import pytest

from act_tpu_torch import profiling


def record(name, us):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(elapsed_us=lambda: us))


def windows(monkeypatch, per_call, lost):
    """kernel_events that returns ``per_call``'s records for each call of a
    window, less the records at the indices ``lost.pop(0)`` of that window."""
    seen = []

    def fake(fn, iters):
        ev = [record(n, us) for _ in range(iters) for n, us in per_call]
        gone = lost.pop(0) if lost else ()
        seen.append(iters)
        return [e for i, e in enumerate(ev) if i not in gone]
    monkeypatch.setattr(profiling, "kernel_events", fake)
    return seen


def test_device_ms_averages_a_complete_window(monkeypatch):
    seen = windows(monkeypatch, [("a", 2.0), ("b", 6.0)], [])
    assert profiling.device_ms(lambda: None, 4) == pytest.approx(0.008)
    assert seen == [4]


@pytest.mark.parametrize("gone", [(0,), (5,), (0, 1)])
def test_device_ms_repeats_a_window_that_lost_records(monkeypatch, gone):
    """The first record, one in the middle, the first call's records."""
    seen = windows(monkeypatch, [("a", 2.0), ("b", 6.0)], [gone])
    assert profiling.device_ms(lambda: None, 4) == pytest.approx(0.008)
    assert seen == [4, 4]


@pytest.mark.parametrize("lost,tries", [([(0,), (3,)], 2), ([range(8), range(8)], 2),
                                        ([(1,)], 1)])
def test_device_ms_reports_none_for_incomplete_windows(monkeypatch, lost, tries):
    """A record lost from every window, every record lost, or one window
    that lost a record and no second try: no time."""
    windows(monkeypatch, [("a", 2.0), ("b", 6.0)], lost)
    assert profiling.device_ms(lambda: None, 4, tries=tries) is None
