"""tests/test_torch_window_parallel_driver.py's comparison of both
packages' window-parallel `run_prox_fitting` with the sequential polish
(`window_polish_mode: sequential`): window 1 re-fitted after window 0 at
the final stage's weights, its head from window 0's solution; on two
ranks the window's owner re-fits it and broadcasts the result."""

import pytest

from test_torch_window_parallel_driver import (  # noqa: F401
    run_both, setup, sharded, test_head_hand_off_is_bit_equal,
    test_result_pkls_have_the_reference_schema,
    test_sharded_run_matches_jax, test_timings_and_broad_phase,
    test_windows_match_jax)


@pytest.fixture(scope="module")
def fits(setup):  # noqa: F811
    return run_both(setup, "sequential")
