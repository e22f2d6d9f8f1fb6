import pytest

# the CPU tests' sizes of amass_s2.c16: full-size body, short clips, few
# steps and clips
AMASS_SMALL = {"clip_frames": 20, "num_fit_steps": 4, "clips_per_call": 2,
               "pool_clips": 4, "check_clips": 3, "profile_steps": [1, 2]}


@pytest.fixture
def card():
    """The CUDA card; the test skips without one (decided here, never at
    import or collection)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
