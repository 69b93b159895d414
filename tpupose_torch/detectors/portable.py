"""Export seam shared by the detector classes (port of
``tpupose/detectors/portable.py``).

The JAX package swaps a live detector's Pallas forward for its XLA twin
here, so that no bundle holds a Mosaic call.  The port keeps its kernels in
bundles: inside ``portable_programs`` every kernel call and the grouping
fold route through the ``tpupose::*`` custom ops of ``ops/library.py``,
which ``torch.export`` traces as opaque calls.  An exported program then
dispatches each op by device when it runs: the hand kernel on the card
(or an error), the plain version on the CPU.  ``serving.py`` wraps every
export in this context.
"""

from __future__ import annotations

from tpupose_torch.ops.library import traced_ops


def portable_programs(det):
    """Context manager: trace ``det``'s program bodies (``_fast_fn`` and the
    rest) through the ``tpupose::*`` ops on this thread.  Live calls in
    other threads keep calling the wrappers directly."""
    del det  # every detector's bodies reach the kernels through the ops
    return traced_ops()
