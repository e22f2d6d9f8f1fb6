"""The share of the fit's steps that ran as replays of a captured step
(`lemo_tpu_torch/fitting/step_graph.py`): 100 x the `replayed` counts
over the `steps` counts of the `lemo.fit` spans in the unprofiled
stretch of timed calls (`portbench.program_spans`), in %. A fit whose
span carries no `replayed` count ran eagerly, and counts 0."""

from portbench import program_spans


def share(rows) -> float | None:
    """100 x the `lemo.fit` rows' replayed steps over their steps; None
    where the log is missing or counts no step."""
    if not rows:
        return None
    fits = [c for n, _, _, _, c in rows if n == "lemo.fit"]
    steps = sum(c.get("steps", 0) for c in fits)
    if steps <= 0:
        return None
    return 100.0 * sum(c.get("replayed", 0) for c in fits) / steps


def read(ctx):
    return share(program_spans.window_log(ctx))
