"""AMASS Stage 2, the temporal clip fit, as `lemo_tpu_torch/cli/
opt_amass_temp.py --clip_batch C` runs it: C clips of one gender folded
into one fit (`fitting.amass_temp.make_temporal_fitter_batched`,
impl='fold') of the shipped step count, loss weights and schedule.

The traffic is a pool of clips made from the seed: smooth pose, shape,
hand and root trajectories, their markers through the plain reference
model plus noise as the targets, foot-contact labels by LEMO's rule, and
the trajectories plus noise as the Stage-1 solution. Each timed call
fits the next C clips of a seeded order through the pool.

The check fits a seeded sample of the clips the window fitted with the
plain reference (`reference.amass_stage2`) from the same inputs, and
compares their first losses, their summed loss over the first three
steps, every step's loss of each clip and how far each clip's fitted
parts moved from the Stage-1 rows (`Runner.numbers`)."""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from portbench import synth
from portbench.reference.amass_stage2 import (Stage2, Weights,
                                              frame0_rotation)
from portbench.trace import span

_IDS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                    "smplx_ids.json")
# the x72 parts that move (betas are frozen), as (name, slice)
LEAVES = (("transl", slice(0, 3)), ("global_orient", slice(3, 6)),
          ("vposer_z", slice(16, 48)), ("left_hand", slice(48, 60)),
          ("right_hand", slice(60, 72)))


def part_rows(x72: torch.Tensor, axis_angle: bool = False) -> list:
    """Each moved part of x72 [n, T, 72] as [n, T, k] rows, the global
    orientation as its rotation matrix (9 entries; as the axis-angle
    itself with `axis_angle`): an axis-angle near a half turn may come
    out as the same rotation with the other sign, 2 pi - angle about the
    flipped axis, so its entries jump where the rotation does not."""
    from portbench.reference.smplx import rodrigues

    out = []
    for name, sl in LEAVES:
        x = x72[..., sl]
        if name == "global_orient" and not axis_angle:
            x = rodrigues(x.reshape(-1, 3)).reshape(x.shape[:2] + (9,))
        out.append(x)
    return out


def load_ids() -> dict:
    with open(_IDS) as fh:
        return json.load(fh)


def contact_labels(feet: torch.Tensor, fps: float, vel_thresh: float = 0.22,
                   z_margin: float = 0.10) -> torch.Tensor:
    """LEMO's foot-contact rule (train_loader_infill.py:175-200): foot
    markers [C, T, 4, 3] (z up) -> labels [C, T, 4], 1 where the marker
    moves slower than 0.22 m/s and lies within 0.10 m of the clip's
    lowest foot marker; the last frame by height alone."""
    vel = torch.linalg.norm((feet[:, 1:] - feet[:, :-1]) * fps, dim=-1)
    slow = torch.cat([(vel < vel_thresh).to(feet.dtype),
                      torch.ones_like(vel[:, :1])], dim=1)
    low = feet[..., 2] < (feet[..., 2].amin(dim=(1, 2), keepdim=True)
                          + z_margin)
    return slow * low.to(feet.dtype)


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def fault(name: str):
    """Plant one of the faults a run of this cell can have in the
    program's timed path (a context manager):

    - state_unchanged: Adam's step returns its parameters unchanged;
    - half_batch: the fold's loss takes the first half of the clips only,
      so the rest never move;
    - answer_altered: the fold hands the first two clips' answers (their
      fitted parameters and loss histories) back in each other's place;
    - output_unfitted: the fit runs whole, but the x72 handed back is
      assembled from the Stage-1 rows."""
    from lemo_tpu_torch.fitting import adam
    from lemo_tpu_torch.fitting import amass_temp as s2

    if name == "state_unchanged":
        return _patched(adam.AdamSpec, "step", lambda self, params, grads,
                        state, lr, dead=None: {k: v.detach()
                                               for k, v in params.items()})
    if name == "half_batch":
        real = s2.run_adam

        def run_half(loss_fn, *a, **kw):
            def half(v):
                _, per = loss_fn(v)
                return per[:(per.shape[0] + 1) // 2].sum(), per
            return real(half, *a, **kw)
        return _patched(s2, "run_adam", run_half)
    if name == "answer_altered":
        real = s2.run_adam

        def run_swapped(*a, **kw):
            final, losses = real(*a, **kw)
            order = torch.arange(losses.shape[0], device=losses.device)
            order[0], order[1] = 1, 0
            return {k: v[order] for k, v in final.items()}, losses[order]
        return _patched(s2, "run_adam", run_swapped)
    if name == "output_unfitted":
        real = s2.run_adam

        def run_unfitted(loss_fn, init, *a, **kw):
            _, losses = real(loss_fn, init, *a, **kw)
            return {k: v.detach().clone() for k, v in init.items()}, losses
        return _patched(s2, "run_adam", run_unfitted)
    raise ValueError(name)


FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "output_unfitted")

# clips the plain reference fits at once (a run checks 16)
REFERENCE_BLOCK = 16


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Runner:
    """One cell of this configuration: `setup()`, then `call(k)` for the
    k-th timed call, `check()` after the window."""

    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.cfg, self.cell, self.seed = config, cell, int(seed)
        self.dev = torch.device(device)
        self.C = int(cell["clips_per_call"])
        self.T = int(config["clip_frames"])
        self.steps = int(config["num_fit_steps"])
        self.frames_per_step = self.C * self.T
        self.steps_per_call = self.steps
        self.records: list = []
        self.fit = None
        self.fit_profiled: dict = {}

    # ---- inputs -----------------------------------------------------
    def _trajectories(self, g, P: int) -> torch.Tensor:
        """[P, T, 72] smooth parameter rows: a walk with a swaying root,
        sinusoidal VPoser latents and hand poses around per-clip means,
        per-clip betas."""
        cell, dev, T = self.cell, self.dev, self.T
        t = (torch.arange(T, device=dev, dtype=torch.float32)
             / float(self.cfg["fps"]))[None, :, None]

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)

        def uni(lo, hi, *shape):
            return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

        def wave(n, amp):
            f = uni(0.3, 1.2, P, 1, n)
            ph = uni(0.0, 2 * np.pi, P, 1, n)
            return amp * rnd(P, 1, n).abs() * torch.sin(2 * np.pi * f * t + ph)

        x = torch.zeros((P, T, 72), device=dev)
        speed = uni(0.0, 0.5, P, 1, 1)
        heading = uni(0.0, 2 * np.pi, P, 1, 1)
        x[..., 0:1] = rnd(P, 1, 1) + speed * t * torch.cos(heading)
        x[..., 1:2] = rnd(P, 1, 1) + speed * t * torch.sin(heading)
        x[..., 2:3] = 0.02 * torch.sin(6.0 * t)
        x[..., 3:5] = 0.1 * rnd(P, 1, 2) + wave(2, 0.05)
        x[..., 5:6] = heading + wave(1, 0.2)
        x[..., 6:16] = cell["betas_std"] * rnd(P, 1, 10)
        x[..., 16:48] = cell["latent_std"] * rnd(P, 1, 32) + wave(
            32, cell["latent_wave"])
        x[..., 48:72] = 0.3 * rnd(P, 1, 24) + wave(24, 0.2)
        return x

    def _pool(self, g):
        """Targets [P, T, 67, 3], contact [P, T, 4], Stage-1 rows
        [P, T, 72] and the smoothness statistics, on the device."""
        P, T = int(self.cell["pool_clips"]), self.T
        true = self._trajectories(g, P)
        init = true.clone()
        noise = self.cell["init_noise"]
        for name, sl in (("transl", slice(0, 3)), ("orient", slice(3, 6)),
                         ("betas", slice(6, 16)), ("latent", slice(16, 48)),
                         ("hands", slice(48, 72))):
            w = sl.stop - sl.start
            init[..., sl] += noise[name] * torch.randn(
                (P, T, w), generator=g, device=self.dev)
        init[..., 6:16] = init[:, :1, 6:16]        # a clip's betas are one
        ids = self.ids
        m67, m81, j0 = [], [], []
        with torch.no_grad():
            for c in range(0, P, self.C):
                x = true[c:c + self.C]
                n = x.shape[0]
                v, j = self.ref.body.forward(
                    x[..., 0:3].reshape(-1, 3), x[..., 3:6].reshape(-1, 3),
                    self._decode(x[..., 16:48].reshape(-1, 32)),
                    x[..., 48:60].reshape(-1, 12),
                    x[..., 60:72].reshape(-1, 12), x[..., 6:16].reshape(-1, 10))
                v = v.reshape(n, T, -1, 3)
                m67.append(v[:, :, ids["markers67"]])
                m81.append(v[:, :, ids["markers81"]])
                j0.append(j.reshape(n, T, -1, 3)[:, 0, :25])
        m67, m81, j0 = (torch.cat(a) for a in (m67, m81, j0))
        targets = m67 + self.cell["marker_noise_m"] * torch.randn(
            m67.shape, generator=g, device=self.dev)
        contact = contact_labels(
            m67[:, :, ids["foot_marker_slots"]], float(self.cfg["fps"]))
        # GlobalStats.compute of the pool's frame-0-normalized markers:
        # a mean a dimension, one std over all
        R = frame0_rotation(j0)
        m = torch.einsum("ctnk,ckl->ctnl", m81 - m81[:, :1, :1], R)
        m = m.reshape(P, T, -1)
        xmean = m.mean(dim=(0, 1))[None, None]
        xstd = torch.full((m.shape[-1],), float(m.std()), device=self.dev)
        return targets, contact, init, xmean, xstd

    def _decode(self, z):
        from portbench.reference.smplx import vposer_decode
        return vposer_decode(self.vpp, z)

    # ---- set-up -----------------------------------------------------
    def setup(self) -> None:
        from lemo_tpu_torch.body_model import load_model
        from lemo_tpu_torch.data.stats import GlobalStats
        from lemo_tpu_torch.fitting import amass_temp as s2

        cfg, dev = self.cfg, self.dev
        g = synth.generator(self.seed, dev)
        self.raw = synth.smplx_model(g, dev, cfg["num_shape_dirs"],
                                     cfg["posedirs_scale"],
                                     cfg["num_verts"], cfg["num_joints"])
        self.vpp = synth.vposer_decoder(g, dev, cfg["vposer_latent"],
                                        cfg["vposer_hidden"])
        self.enc = synth.smooth_encoder(g, dev, cfg["smooth_z_channel"])
        self.ids = load_ids()
        self.weights = Weights(**cfg["weights"])
        self.ref = Stage2(self.raw, self.vpp, self.enc, None, None,
                          self.ids["markers67"], self.ids["markers81"],
                          self.ids["feet"], self.weights)
        (self.targets, self.contact, self.init72, xmean,
         xstd) = self._pool(g)
        self.ref.xmean, self.ref.xstd = xmean, xstd
        P = self.targets.shape[0]
        rng = np.random.default_rng(self.seed % (1 << 63))
        self.order = [rng.permutation(P) for _ in range(64)]

        model = load_model(synth.to_numpy(self.raw), gender="male",
                           use_pca=True, num_pca_comps=cfg["num_pca_comps"],
                           device=dev)
        stats = GlobalStats(Xmean=xmean, Xstd=xstd)
        self.make = lambda steps: s2.make_temporal_fitter_batched(
            model, self.vpp, self.enc, stats, self.ids["markers67"],
            self.ids["markers81"], self.ids["feet"], num_steps=steps,
            weights=s2.Stage2Weights(**cfg["weights"]), impl="fold",
            device=dev)
        self.fit = self.make(self.steps)
        self._fit_batch(self.fit, self._batch(0))   # warm-up, not recorded
        sync(dev)

    def prepare_profile(self) -> None:
        """The traced run's short calls: the same fitter factory at each of
        `profile_steps` steps, each run once before it is profiled."""
        for n in self.profile_steps:
            self.fit_profiled[n] = self.make(n)
            self._fit_batch(self.fit_profiled[n], self._batch(1))
        sync(self.dev)

    def _batch(self, k: int) -> torch.Tensor:
        per = self.targets.shape[0] // self.C
        perm = self.order[(k // per) % len(self.order)]
        return torch.as_tensor(perm[(k % per) * self.C:(k % per + 1) * self.C],
                               device=self.dev)

    def _fit_batch(self, fit, idx):
        with span("data_prep"):
            args = (self.targets[idx], self.contact[idx], self.init72[idx])
        with span("fit_call"):
            return fit(*args)

    # ---- the timed path -----------------------------------------------
    def call(self, k: int) -> None:
        idx = self._batch(k)
        x72, losses = self._fit_batch(self.fit, idx)
        self.records.append((idx, x72, losses))

    def profiled_call(self, n: int) -> None:
        self._fit_batch(self.fit_profiled[n], self._batch(2))
        with span("sync"):
            sync(self.dev)

    @property
    def profile_steps(self) -> tuple[int, int]:
        """The steps of the two profiled calls (`trace.PerStep`)."""
        n1, n2 = (int(n) for n in self.cell["profile_steps"])
        return n1, n2

    def attempted_failed(self) -> tuple[int, int]:
        n = sum(int(r[0].numel()) for r in self.records)
        bad = sum(int((~torch.isfinite(r[2])).any(dim=1).sum())
                  for r in self.records)
        return n, bad

    # ---- what the per-layer readers take ------------------------------
    def launch_counters(self) -> dict:
        from lemo_tpu_torch.body_model import chain_cuda, vertex_cuda
        return {**chain_cuda.launches, **vertex_cuda.launches}

    def body_kernel_shape(self) -> tuple[int, int, int, int]:
        """(B, V, J, D) of each body-kernel launch: the fold's frames, the
        vertices, the joints and the blend columns (betas and expression,
        the pose features, the template's 1)."""
        J = self.cfg["num_joints"]
        return (self.frames_per_step, self.cfg["num_verts"], J,
                self.cfg["num_betas"] + self.cfg["num_expressions"]
                + 9 * (J - 1) + 1)

    def step_flops(self) -> float:
        """One Adam step's loss and gradient through the plain reference
        at the timed batch, counted on the meta device."""
        from portbench.flops import count_flops, to_meta

        raw = dict(to_meta(self.raw), kintree_table=self.raw["kintree_table"])
        ref = Stage2(raw, to_meta(self.vpp),
                     to_meta(self.enc), to_meta(self.ref.xmean),
                     to_meta(self.ref.xstd), self.ids["markers67"],
                     self.ids["markers81"], self.ids["feet"], self.weights)
        ref.ids67, ref.ids81, ref.foot = (to_meta(t) for t in (
            ref.ids67, ref.ids81, ref.foot))
        C, T = self.C, self.T
        meta = torch.device("meta")
        v = {"transl": torch.empty((C, T, 3), device=meta,
                                   requires_grad=True),
             "rot6d": torch.empty((C, T, 6), device=meta, requires_grad=True),
             "other": torch.empty((C, T, 56), device=meta,
                                  requires_grad=True)}

        def step():
            per_clip = ref.loss(v, torch.empty((C, T, 10), device=meta),
                                torch.empty((C, T, 67, 3), device=meta),
                                torch.empty((C, T, 4), device=meta))
            torch.autograd.grad(per_clip.sum(), list(v.values()))

        return count_flops(step)

    # ---- after the window -------------------------------------------
    def release(self) -> None:
        """Drop the program's fitters and model, keep the inputs and the
        window's outputs."""
        self.fit = self.make = None
        self.fit_profiled = {}
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A seeded sample of `check_clips` of the clips the window fitted:
        (pool ids [n], the program's x72 [n, T, 72] and losses [n, S])."""
        ids = torch.cat([r[0] for r in self.records])
        x72 = torch.cat([r[1] for r in self.records])
        losses = torch.cat([r[2] for r in self.records])
        n = min(int(self.cell["check_clips"]), ids.numel())
        rng = np.random.default_rng((self.seed + 1) % (1 << 63))
        pick = torch.as_tensor(np.sort(rng.choice(ids.numel(), n,
                                                  replace=False)),
                               device=ids.device)
        return ids[pick], x72[pick], losses[pick]

    def fault_fit(self, name: str, ids):
        """The program's fit of pool clips `ids` with fault `name` planted
        (before `release`)."""
        with fault(name):
            x72, losses = self._fit_batch(self.fit, ids)
        return x72, losses

    def reference_fit(self, ids, tf32: bool = False):
        """The plain reference's fit of pool clips `ids` (float32 with TF32
        off; `tf32` on for the control), `REFERENCE_BLOCK` clips at a time
        (each clip is its own problem)."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            outs = [self.ref.fit(self.targets[b], self.contact[b],
                                 self.init72[b], self.steps)
                    for b in torch.split(ids, REFERENCE_BLOCK)]
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def _moves(self, ids, x72, x72_ref, axis_angle: bool = False):
        """Each moved part's distance from its Stage-1 value [n, parts]
        (`part_rows`), the program's and the reference's, and their gap
        over the larger of the reference's distance and the median
        part's."""
        init = part_rows(self.init72[ids], axis_angle)

        def dist(x):
            return torch.stack([torch.linalg.norm(a - b, dim=(1, 2))
                                for a, b in zip(part_rows(x, axis_angle),
                                                init)], 1)

        dp, dr = dist(x72), dist(x72_ref)
        mv = (dp - dr).abs() / torch.clamp(dr, min=float(dr.median()))
        return mv, dp, dr

    def numbers(self, ids, x72, losses, x72_ref, losses_ref) -> dict:
        """The numbers of fitted clips against the reference's:

        - loss0_gap: the widest relative gap of a clip's first loss, the
          forward at its Stage-1 rows;
        - fold3_gap: the widest relative gap of the clips' summed loss
          (the fold's objective) over the first three steps, after one
          and two Adam updates;
        - loss_gap: the widest relative gap of a clip's loss over all
          steps;
        - move_gap: the widest gap of a moved part's distance from its
          Stage-1 value in the fitted x72 (the program's norm against
          the reference's, over the larger of the reference's and the
          median part's; the orientation as a rotation, `part_rows`);
        - not compared: loss3_gap, a clip's loss over the first three
          steps; move_gap_aa, move_gap with the orientation's axis-angle
          entries.

        The cell's file names the compared ones and their limits."""
        def rel(a, b):
            out = (a - b).abs() / b.abs()
            return float(out.max()) if torch.isfinite(out).all() else \
                float("inf")

        def widest(mv):
            return float(mv.max()) if torch.isfinite(mv).all() else \
                float("inf")

        mv, _, _ = self._moves(ids, x72, x72_ref)
        mv_aa, _, _ = self._moves(ids, x72, x72_ref, axis_angle=True)
        return {"loss0_gap": rel(losses[:, 0], losses_ref[:, 0]),
                "fold3_gap": rel(losses[:, :3].sum(0),
                                 losses_ref[:, :3].sum(0)),
                "loss3_gap": rel(losses[:, :3], losses_ref[:, :3]),
                "loss_gap": rel(losses, losses_ref),
                "move_gap": widest(mv), "move_gap_aa": widest(mv_aa)}

    def look(self, ids, x72, losses, x72_ref, losses_ref) -> dict:
        """Per clip, where `move_gap` and `loss_gap` come from: the part
        with the widest move gap, both distances, the median part's, each
        part's gap (`gaps`, and `gaps_aa` with the axis-angle), the
        clip's widest loss gap, the first step at which its loss is 1e-4
        apart, and both final losses."""
        mv, dp, dr = self._moves(ids, x72, x72_ref)
        mv_aa, _, _ = self._moves(ids, x72, x72_ref, axis_angle=True)
        lg = (losses - losses_ref).abs() / losses_ref.abs()
        rows = []
        for c in range(len(ids)):
            j = int(mv[c].argmax())
            apart = torch.nonzero(lg[c] > 1e-4)
            rows.append({
                "clip": int(ids[c]), "part": LEAVES[j][0],
                "move_gap": float(mv[c, j]), "program": float(dp[c, j]),
                "reference": float(dr[c, j]),
                "gaps": [float(v) for v in mv[c]],
                "gaps_aa": [float(v) for v in mv_aa[c]],
                "loss_gap": float(lg[c].max()),
                "apart_from": int(apart[0]) if len(apart) else None,
                "final": [float(losses[c, -1]), float(losses_ref[c, -1])]})
        return {"median_part": float(dr.median()),
                "parts": [n for n, _ in LEAVES], "clips": rows}

    def check(self) -> dict:
        """The compared numbers of the window's sampled clips."""
        ids, x72, losses = self.sample()
        x72_ref, losses_ref = self.reference_fit(ids)
        return self.numbers(ids, x72, losses, x72_ref, losses_ref)
