"""Run logging: tensorboard scalars, a file logger and config snapshots
(port of `lemo_tpu/utils/logging.py`).

The reference's observability surface: tensorboardX SummaryWriter
scalars (train_smooth_prior.py:140-195, fitting_temp_slide.py:293-307),
the file logger (utils/utils.py:18-28) and params.json config snapshots
(utils/utils.py:30-34). tensorboardX is optional: without it only the
file logger and params.json are written.
"""

from __future__ import annotations

import datetime
import json
import logging
import os


class RunLogger:
    def __init__(self, logdir: str, config: dict | None = None,
                 use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.writer = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(log_dir=logdir)
            except ImportError:
                pass
        ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        handler = logging.FileHandler(
            os.path.join(logdir, f"run_{ts}.log"))
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        self.logger = logging.getLogger(f"lemo_tpu_torch.{logdir}")
        self.logger.addHandler(handler)
        self.logger.setLevel(logging.INFO)
        if config is not None:
            self.save_config(config)

    def save_config(self, config: dict) -> None:
        """params.json: the config's plain values, sorted, indent 4."""
        path = os.path.join(self.logdir, "params.json")
        with open(path, "w") as fh:
            json.dump({k: v for k, v in config.items()
                       if isinstance(v, (int, float, str, bool, list,
                                         type(None)))},
                      fh, indent=4, sort_keys=True)

    def log_scalars(self, prefix: str, values: dict, step: int) -> None:
        for k, v in values.items():
            if isinstance(v, (int, float)):
                if self.writer is not None:
                    self.writer.add_scalar(f"{prefix}/{k}", v, step)
        self.logger.info("step %d %s %s", step, prefix,
                         {k: v for k, v in values.items()
                          if isinstance(v, (int, float))})

    def info(self, msg: str) -> None:
        self.logger.info(msg)
