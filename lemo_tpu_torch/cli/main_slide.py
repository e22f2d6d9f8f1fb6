"""PROX sliding-window fitting CLI on the port (reference
temp_prox/main_slide.py):

  python -m lemo_tpu_torch.cli.main_slide \
      --config cfg_files/PROXD_temp_S3_all_terms.yaml \
      --recording_dir /path/to/PROX/recordings/N3OpenArea_00157_01 \
      --model_folder /path/to/body_models --vposer_ckpt /path/to/vposer \
      --part_segm_fn /path/to/body_models/smplx_parts_segm.pkl

Runs on the CUDA card. `--window_parallel true` fits all windows at once
(`--window_polish_iters`, `--window_polish_mode jacobi|sequential` and
`--window_polish_rounds` set its polish pass). On N cards, one process
each, the windows are sharded over the processes and rank 0 writes the
results:

  torchrun --nproc_per_node N -m lemo_tpu_torch.cli.main_slide \
      --config ... --recording_dir ... --window_parallel true
"""

from __future__ import annotations

import sys


def main(argv=None, device=None):
    """`device`: where the fit runs (None: the CUDA card; under
    `torchrun`, `cuda:LOCAL_RANK`)."""
    from lemo_tpu_torch.config import parse_config
    from lemo_tpu_torch.fitting.prox.driver import run_prox_fitting
    from lemo_tpu_torch.parallel import initialize_multihost

    initialize_multihost(device=device)   # a no-op in one process

    cfg = parse_config(sys.argv[1:] if argv is None else argv)
    if not cfg.recording_dir:
        print("error: --recording_dir is required", file=sys.stderr)
        sys.exit(2)
    return run_prox_fitting(cfg, device=device)


if __name__ == "__main__":
    main()
