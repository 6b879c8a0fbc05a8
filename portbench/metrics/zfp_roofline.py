"""zfp_roofline: the codec kernels' share of their roofline in the
window. The bytes they need (each unit's raw values, payload and emax
once, from the plan's unit shapes; ``plan.sweep_codec``) over the
data sheet's HBM rate, divided by the device time of the encode and
decode launches in the trace (``encode_kernel``/``decode_kernel``,
``encode64_kernel``/``decode64_kernel``). A direction whose kernel does
not appear is not counted; nothing when neither does. Layer: the codec."""

from portbench import plan

KERNELS = {"decode": r"decode(64)?_kernel", "encode": r"encode(64)?_kernel"}


def read(w):
    if w.trace is None:
        return None
    e = w.engine
    need = plan.sweep_codec(e.shape, e.ndiv, e.bt, e.fields, e.dtype)
    nbytes = seconds = 0.0
    for kind, pattern in KERNELS.items():
        ops = w.trace.kernels(pattern)
        if not ops:
            continue
        nbytes += w.sweeps * need[kind][1]
        seconds += sum(o.end - o.start for o in ops)
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / plan.PEAK_HBM_BYTES_PER_S / seconds
