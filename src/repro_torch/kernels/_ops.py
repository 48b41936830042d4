"""The kernels as ``torch.library`` operators (namespace ``repro_torch``).

Each wrapper calls its operator, whose implementations are the plain
version for CPU tensors and the ctypes launch (with its launch counter)
for CUDA tensors. A fake or meta tensor (``FakeTensorMode``: the dry-run)
reaches only the operator's fake implementation, which gives the output
shapes and dtypes, and never a launch. Each operator also has a FLOP
formula (``torch.utils.flop_counter``), counting what ``chip_smoke.py``'s
bound counts for it. Defining the operators builds nothing.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable,
           flops: Callable):
    """Define ``repro_torch::name`` with ``schema`` (the arguments and
    results, e.g. "(Tensor x) -> Tensor") and return the operator.
    ``flops(*args, out_val=...)`` takes the call's tensors (real or fake)."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(op, get_raw=True)(flops)
    return op
