"""utils/timing.py in the port: the contracts atq_tpu's timing module
holds (tests/test_timing.py:25-58) on a trivial chained step on the CPU,
``sec_per_call``'s slope timing, and ``sync_tree`` over nested outputs.
On the CPU these are host-clock times, and the stats say so."""

import pytest
import torch

from atq_tpu_torch.utils import timing
from atq_tpu_torch.utils.timing import (
    sec_per_call,
    steady_state_sec_per_step,
    steady_state_step_stats,
    sync_tree,
)


@pytest.fixture(autouse=True)
def _short_windows(monkeypatch):
    """Windows of ~0.05 s in place of 0.6 s: the contracts, not the
    numbers, are under test."""
    monkeypatch.setattr(timing, "_TARGET_WINDOW_SEC", 0.05)


def _step(state):
    new = state + 1.0
    return new, new.sum()


def test_step_stats_contract():
    stats, final = steady_state_step_stats(
        _step, torch.zeros(16), (), warmup=1, iters=5, windows=5)
    ws = stats["windows_sec_per_step"]
    assert len(ws) == 5
    assert ws == sorted(ws)
    assert stats["sec_per_step_best"] == ws[0]
    assert ws[0] <= stats["sec_per_step_median"] <= ws[-1]
    assert stats["sec_per_step_median"] == ws[2]
    assert stats["sec_per_step_iqr"] >= 0.0
    assert stats["iters_per_window"] >= 5
    assert stats["devices"] == ["cpu"]
    assert stats["clock"] == "host clock (CPU run)"
    # The state threads through every warm-up, pilot and window call.
    calls = 1 + 5 + 5 * stats["iters_per_window"]
    assert float(final[0]) == calls


def test_step_stats_median_even_windows():
    stats, _ = steady_state_step_stats(_step, torch.zeros(4), (), warmup=1,
                                       iters=4, windows=4)
    ws = stats["windows_sec_per_step"]
    assert len(ws) == 4
    assert stats["sec_per_step_median"] == 0.5 * (ws[1] + ws[2])


def test_step_stats_min_windows_clamped():
    stats, _ = steady_state_step_stats(_step, torch.zeros(4), (), warmup=1,
                                       iters=4, windows=1)
    assert len(stats["windows_sec_per_step"]) == 3


def test_best_window_api_still_works():
    sec, final = steady_state_sec_per_step(_step, torch.zeros(4), (),
                                           warmup=1, iters=4, device="cpu")
    assert sec > 0
    assert float(final[0]) == 5


def test_sec_per_call_is_the_best_window_slope():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": [x * 2.0, (x + 1.0,)]}

    sec = sec_per_call(fn, torch.ones(8), warmup=2, iters=4, windows=3)
    assert 0 < sec < 0.05
    n = (len(calls) - 2 - 3 * 4) // 3  # the calls of one sized window
    assert n >= 4 and len(calls) == 2 + 3 * 4 + 3 * n


def test_sync_tree_takes_nested_outputs():
    sync_tree(None)
    sync_tree({"a": [torch.zeros(2), (torch.ones(1), 3)], "b": "text"})
    assert timing._devices({"a": [torch.zeros(2)], "b": 1.0}) == [
        torch.device("cpu")]
