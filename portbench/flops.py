"""The FLOPs of one step as torch's FlopCounterMode counts them: matrix
products and convolutions, forward and backward (a frozen copy of the
trainers' count in `chip_smoke.py:_step_flops`). The step is the
benchmark's plain reference, run on the meta device at the timed shapes,
so the count costs no device time or memory and does not depend on how
the program computes the step."""

from __future__ import annotations


def to_meta(tree):
    """A (nested) dict or list of tensors -> the same on the meta device."""
    import torch

    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    return tree


def count_flops(fn, *args, **kwargs) -> float:
    """Total FLOPs of fn(*args, **kwargs) under FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return float(fc.get_total_flops())
