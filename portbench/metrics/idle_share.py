"""idle_share: the share of the traced window in which no kernel ran
on the device, 1 - the union of the kernels' intervals over the window
(copies not counted: this is the compute engine's idle time). Layer:
the device."""


def read(w):
    if w.trace is None or w.trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy(("kernel",)) / w.trace.seconds)
