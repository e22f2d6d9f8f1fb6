"""The optimizer factory (port of `lemo_tpu/fitting/lbfgs.py:
create_optimizer`, optim_factory.py:27-65). The port has the Adam engine
(`fitting/adam.py`); L-BFGS, L-BFGS with line search, RMSprop and SGD are
not ported yet (ROADMAP.md queue 1) and raise."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdamSpec:
    """What `fitting.adam.run_adam` needs: a constant learning rate and
    the moment decays."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def create_optimizer(optim_type: str = "adam", lr: float = 1e-3, **kw):
    if optim_type == "adam":
        return AdamSpec(lr=float(lr), b1=kw.get("beta1", 0.9),
                        b2=kw.get("beta2", 0.999))
    if optim_type in ("lbfgs", "lbfgsls", "rmsprop", "sgd"):
        raise NotImplementedError(
            f"optim_type {optim_type!r} is not ported to lemo_tpu_torch yet "
            "(ROADMAP.md queue 1: the L-BFGS/RMSprop/SGD optimizers); use "
            "optim_type 'adam'")
    raise ValueError(f"Optimizer {optim_type} not supported!")
