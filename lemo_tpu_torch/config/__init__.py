"""PROX configuration (port of `lemo_tpu/config`)."""

from lemo_tpu_torch.config.prox_config import ProxConfig, parse_config

__all__ = ["ProxConfig", "parse_config"]
