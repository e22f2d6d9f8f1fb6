"""One module a configuration, named as the configuration, holding
`Runner(config, cell, seed, device)`:

- `setup()`: inputs and weights from the seed, the program's timed
  entry, a warm-up call of the timed shapes;
- `call(k)`: the k-th timed call; `frames_per_step`, `steps_per_call`;
- `attempted_failed()`, `release()`, `check()` -> {number: value};
- for the traced run: `prepare_profile()`, `profiled_call(n)`,
  `profile_steps` (n1 < n2), and what the per-layer readers take
  (`launch_counters()`, `body_kernel_shape()`, `step_flops()`).
"""
