"""stencil_roofline: the rung kernel's share of its roofline in the
window. Each rung (a step of a block visit, B + 2H planes: ``bt`` a
visit) needs four arrays of the block once (p_prev, p_cur, vel2 read,
p_next written; ``plan.sweep_rungs``); the window's sweeps' bytes over
the data sheet's HBM rate, divided by the device time of the ``wave_rung_kernel`` /
``wave_rung64_kernel`` launches in the trace. Nothing when the kernel
does not appear. Layer: the stencil."""

from portbench import plan


def read(w):
    if w.trace is None:
        return None
    ops = w.trace.kernels(r"wave_rung(64)?_kernel")
    if not ops:
        return None
    e = w.engine
    nbytes = w.sweeps * plan.sweep_rungs(e.shape, e.ndiv, e.bt, e.dtype)[1]
    seconds = sum(o.end - o.start for o in ops)
    return 100.0 * nbytes / plan.PEAK_HBM_BYTES_PER_S / seconds
