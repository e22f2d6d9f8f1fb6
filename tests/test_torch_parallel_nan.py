"""The frame-sharded fit's freeze on the CPU: `lemo_tpu` freezes a fit
whole when its loss goes NaN/Inf (`lemo_tpu/fitting/adam.py:66-71`), and
its frame-sharded Stage 1 is one program over one mean, so a NaN in any
frame stops every frame. The port's `frame_sharded_fit` runs `run_adam`
on each rank's share of the loss and ORs the ranks' freeze flags each
step (`run_adam(reduce_dead=...)`). On two spawned gloo ranks (one spawn,
`ranks` fixture): a NaN marker target in rank 1's frames of the Stage 1
freezes both ranks at step 0, as `lemo_tpu`'s and the port's
one-process fits freeze; and a fit whose loss goes NaN mid-fit in one
rank's frames (`parallel.dryrun.poisoned_fit`) freezes both ranks at
that step, bit for bit as one process over all frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.data import markers as j_markers
from lemo_tpu.fitting import amass_perframe as j_s1
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting import amass_perframe as t_s1
from lemo_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

# Stage 1 as tests/test_torch_parallel.py: T1 frames, 4 a rank
T1, S1 = 8, 5
NAN_FRAME = 6
# the poisoned fit's frames: targets, and the step from which each frame
# poisons its share of the loss (only frame 5, rank 1's, ever does)
POISON_STEP = 3
POISONED = torch.tensor([[0.5 * i, 99.0] for i in range(7)])
POISONED[5, 1] = POISON_STEP


@pytest.fixture(scope="module")
def stage1():
    """The Stage-1 inputs with a NaN marker in frame NAN_FRAME, and
    lemo_tpu's and the port's one-process fits of them."""
    md = synthetic_smplx_npz(num_verts=128)
    vpp = {k: np.asarray(v) for k, v in
           j_vp.init_vposer(jax.random.PRNGKey(1)).items()}
    ids = j_markers.marker_indices(False, num_verts=128)
    target = (np.random.RandomState(1).randn(T1, 67, 3) * 0.2).astype(
        np.float32)
    target[NAN_FRAME, 3, 1] = np.nan
    x_j, l_j = j_s1.make_stage1_fitter(
        j_load(md, use_pca=True, num_pca_comps=12), vpp, ids,
        num_steps=S1)(jnp.asarray(target), jnp.zeros(10))
    model = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    args = (model, from_numpy_tree(vpp, "cpu"), ids)
    x_t, l_t = t_s1.make_stage1_fitter(*args, num_steps=S1, device="cpu")(
        torch.as_tensor(target), torch.zeros(10))
    return args, target, (np.array(x_j), np.array(l_j)), (x_t, l_t)


@pytest.fixture(scope="module")
def ranks(stage1):
    args, target, _, _ = stage1
    jobs = [
        (dryrun.job_stage1, {"fitter_args": args,
                             "fitter_kw": {"num_steps": S1,
                                           "device": "cpu"},
                             "target": torch.as_tensor(target),
                             "beta": torch.zeros(10)}),
        (dryrun.job_nan_freeze, {"frames": POISONED}),
    ]
    return dryrun.spawn_ranks(2, dryrun.job_sequence, {"jobs": jobs},
                              device="cpu", threads=2, timeout=600)


def test_a_nan_in_one_ranks_frames_freezes_every_rank(ranks, stage1):
    """The NaN makes the unsharded loss NaN from step 0, so lemo_tpu and
    the port's one process keep the initial parameters; so must both
    ranks, rank 0's frames included, and the gathered result is the
    one-process fit's bit for bit."""
    _, _, (x_j, l_j), (x_t, l_t) = stage1
    assert np.isnan(l_j).all() and torch.isnan(l_t).all()
    np.testing.assert_allclose(x_t.numpy(), x_j, atol=1e-6)
    for r in ranks:
        out = r[0]
        assert torch.isnan(out["losses"]).all()
        assert torch.equal(out["x72"], x_t)


def test_a_mid_fit_nan_freezes_both_ranks_at_its_step(ranks):
    """`poisoned_fit` on 7 frames, frame 5 (rank 1's) poisoning the loss
    from step POISON_STEP: both ranks keep the parameters of step
    POISON_STEP, as one process over all frames does, bit for bit, and
    the clean fit goes on moving them."""
    x_one, l_one = dryrun.poisoned_fit(POISONED)
    x_stop, _ = dryrun.poisoned_fit(POISONED, steps=POISON_STEP)
    clean = POISONED.clone()
    clean[:, 1] = 99.0
    x_clean, _ = dryrun.poisoned_fit(clean)
    assert torch.equal(x_one, x_stop)
    assert not torch.equal(x_one[:4], x_clean[:4])
    assert torch.isfinite(l_one[:POISON_STEP]).all()
    assert torch.isnan(l_one[POISON_STEP:]).all()
    for r in ranks:
        x, losses = r[1]
        assert torch.equal(x, x_one)
        torch.testing.assert_close(losses, l_one, rtol=1e-6, atol=0,
                                   equal_nan=True)
