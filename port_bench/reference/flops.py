"""Model FLOPs of the reference, counted by operation as it runs.

:class:`FlopCount` is a dispatch mode that applies the formulas of
``torch.utils.flop_counter`` (``flop_registry``, FlopCounterMode's table:
``2·m·k·n`` for a product of (m, k) and (k, n), and so on) to every
operation the reference runs inside it, forward and backward, and files
each count under the dtype of the product's first operand, or bf16 inside
:func:`counted_as_bf16`: a bf16 product runs on the tensor cores at the
bf16 peak, an f32 one at the f32-accurate product peak
(``lib/roofline.py``).  Selection work (the kNN distance
products, FPS, ball queries) is no model arithmetic: the reference runs it
inside :func:`uncounted`.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("flop_count",
                                                         default=None)


@contextlib.contextmanager
def uncounted():
    """Operations in the block add nothing to the active :class:`FlopCount`
    (none active: no effect)."""
    counter = _ACTIVE.get()
    if counter is None:
        yield
        return
    counter.paused += 1
    try:
        yield
    finally:
        counter.paused -= 1


@contextlib.contextmanager
def counted_as_bf16():
    """Products in the block count at the bf16 peak: their operands hold
    bf16 values in f32 tensors, as the benchmarked kernel's do."""
    counter = _ACTIVE.get()
    if counter is None:
        yield
        return
    counter.bf16 += 1
    try:
        yield
    finally:
        counter.bf16 -= 1


def _first_dtype(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.dtype
    return torch.float32


class FlopCount(TorchDispatchMode):
    """``with FlopCount() as c: ...`` → ``c.by_dtype`` {dtype: FLOPs}."""

    def __init__(self):
        super().__init__()
        self.by_dtype: dict = defaultdict(int)
        self.paused = 0
        self.bf16 = 0
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and not self.paused:
            dtype = torch.bfloat16 if self.bf16 else _first_dtype(args)
            self.by_dtype[dtype] += int(
                formula(*args, **kwargs, out_val=out))
        return out
