"""FLOPs of one call of a train step (counterpart of ``ops/flops.py``).

The reference's ``mxu_flops`` walks a jaxpr and counts the FLOPs of its
matrix products and convolutions (forward, backward and optimizer, since it
runs on the whole step).  Here :func:`step_flops` runs the call under
``torch.utils.flop_counter.FlopCounterMode``, which counts the same two
kinds of operation (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions
and their backward) as PyTorch dispatches them.

A CUDA kernel of ``ops/kernels/`` is a ``ctypes`` call that the counter
cannot see, and its plain version on a CPU tensor runs torch products that
the counter does see (the sparse attention's as a dense T x T emulation).
So that the count does not depend on what implements a kernel, each
wrapper runs its kernel or its plain version inside :func:`kernel_flops`,
which replaces whatever the counter saw there by the FLOPs of the kernel's
function, computed from its shapes: the masked attention's two products
over Tq x Tk, the sparse attention's products over its live key blocks,
and 0 for the PoE, KL and sampling kernels, which hold no product.  A
step reads the same integer on the card and on the CPU.

Where a Python loop stands for the reference's ``scan``, its products are
counted once per pass, as ``mxu_flops`` multiplies a scan's body by its
length; eager PyTorch has no ``while`` whose trip count the count would
miss, so ``lower_bound`` is always False.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

from torch.utils.flop_counter import FlopCounterMode

_counter: Optional[FlopCounterMode] = None   # the counter of the running step_flops
_correction = 0                               # kernels' FLOPs less what it saw of them


@contextlib.contextmanager
def kernel_flops(flops: int):
    """Count ``flops`` for the kernel call inside, in place of the products
    the counter sees it dispatch (its plain version's); outside
    :func:`step_flops` it does nothing."""
    global _correction
    counter = _counter
    if counter is None:
        yield
        return
    before = counter.get_total_flops()
    try:
        yield
    finally:
        _correction += int(flops) - (counter.get_total_flops() - before)


def step_flops(fn, *args, **kwargs) -> Dict[str, Any]:
    """Matrix-product and convolution FLOPs of one call of
    ``fn(*args, **kwargs)``, with every kernel counted by its function.

    :return: ``{"flops": int, "lower_bound": False}``, the reference's keys
        (its ``mxu_flops`` under the name ``flops``)
    """
    global _counter, _correction
    if _counter is not None:
        raise RuntimeError("step_flops calls do not nest")
    counter = FlopCounterMode(display=False)
    _counter, _correction = counter, 0
    try:
        with counter:
            fn(*args, **kwargs)
        flops = counter.get_total_flops() + _correction
    finally:
        _counter, _correction = None, 0
    return {"flops": int(flops), "lower_bound": False}
