"""Per-layer metric readers: `<name>.read(ctx)` -> a number, or None
where the traced run holds nothing to read (the harness then leaves the
metric out of the line). `ctx` is `portbench.run.Context`."""
