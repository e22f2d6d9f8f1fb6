"""The benchmark of `lemo_tpu_torch` on one NVIDIA H100.

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own that the harness finds by the
name in `BENCHMARK.json`:

- `configs/<config>.json`: the configuration's sizes, source and cuts;
- `runners/<config>.py`: its set-up, one timed call and its check;
- `workloads/<cell>.json`: the cell's configuration and traffic;
- `metrics/<metric>.py`: `read(ctx)`, one per-layer metric.

The yardstick (the operation and byte counts, the peaks, the profiler
reduction, the FLOP count and the plain reference in `reference/`) lives
here, so that a change to the program cannot move it.
"""
