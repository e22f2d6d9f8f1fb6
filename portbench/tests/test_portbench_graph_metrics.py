"""The readers of the captured step (`graph_step_share`,
`host_replay_ms_per_step`) on hand-made span logs: replayed fits, eager
fits (a program that captures nothing reads 0 and no replay time), the
launch time read from each fit's first replays only, and nothing from an
empty or missing log."""

import pytest

from portbench import program_spans
from portbench.metrics import graph_step_share, host_replay_ms_per_step


def _log(replayed: bool):
    """Two fits of 2 and 3 steps, each step 0.4 ms of replay where
    `replayed` (its span counting `replayed`), else the eager spans."""
    rows, t = [], 0
    for steps in (2, 3):
        fit = len(rows)
        counts = {"steps": steps, "replayed": steps} if replayed else \
            {"steps": steps}
        rows.append(["lemo.fit", t, None, None, counts])
        for _ in range(steps):
            if replayed:
                rows.append(("lemo.step.replay", t, t + 400_000, fit, {}))
            else:
                rows.append(("lemo.step.forward", t, t + 400_000, fit, {}))
            t += 1_000_000
        rows[fit][2] = t
        rows[fit] = tuple(rows[fit])
    return rows


def _mixed():
    """A replayed fit of 3 steps beside an eager fit of 2."""
    return [("lemo.fit", 0, 3_000_000, None, {"steps": 3, "replayed": 3}),
            ("lemo.fit", 3_000_000, 5_000_000, None, {"steps": 2})]


@pytest.mark.parametrize("log,share,ms", [
    (_log(True), 100.0, 0.4), (_log(False), 0.0, None),
    (_mixed(), 60.0, None), ([], None, None), (None, None, None),
    ([r for r in _log(True) if r[0] != "lemo.fit"], None, None)])
def test_readers_read_hand_made_logs(monkeypatch, log, share, ms):
    monkeypatch.setattr(program_spans, "window_log", lambda ctx: log)
    got = graph_step_share.read(object())
    assert got == (pytest.approx(share) if share is not None else None)
    got = host_replay_ms_per_step.read(object())
    assert got == (pytest.approx(ms) if ms is not None else None)


def test_replay_ms_reads_each_fits_first_replays():
    """Replays 0.2 ms each until the queue fills, 40 ms after: the reader
    takes each fit's first FIRST."""
    first = host_replay_ms_per_step.FIRST
    rows, t = [], 0
    for fit in (0, 20):
        rows.append(("lemo.fit", t, t + 1, None, {"steps": 19,
                                                  "replayed": 19}))
        for i in range(19):
            ns = 200_000 if i < first + 2 else 40_000_000
            rows.append(("lemo.step.replay", t, t + ns, fit, {}))
            t += ns
    assert len(rows) == 40
    assert host_replay_ms_per_step.launch_ms(rows) == pytest.approx(0.2)
