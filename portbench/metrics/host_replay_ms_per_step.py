"""Host ms to launch one replayed step of the fit's captured step: the
`lemo.step.replay` span around a replay of the CUDA graph in
`fitting/step_graph.py`, over an unprofiled stretch of timed calls
(`portbench.program_spans`). Only the first `FIRST` replays of each fit
are read: the stretch's calls start with the card idle, so those spans
hold the launch alone, while a later replay waits for room in the
card's launch queue and so reads the card's pace, not the host's. The
mean over those spans; None where the fit runs eagerly."""

from portbench import program_spans

# replays of each fit read, before the launch queue fills
FIRST = 4


def launch_ms(rows) -> float | None:
    """Mean ms of the first `FIRST` `lemo.step.replay` spans of each
    `lemo.fit` (the row that holds them); None where there are none."""
    if not rows:
        return None
    by_fit: dict = {}
    for name, start, end, parent, _ in rows:
        if name == "lemo.step.replay" and end is not None and \
                parent is not None and parent < len(rows) and \
                rows[parent][0] == "lemo.fit":
            by_fit.setdefault(parent, []).append(end - start)
    first = [ns for spans in by_fit.values() for ns in spans[:FIRST]]
    if not first:
        return None
    return sum(first) / len(first) / 1e6


def read(ctx):
    return launch_ms(program_spans.window_log(ctx))
