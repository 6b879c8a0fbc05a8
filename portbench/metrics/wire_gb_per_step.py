"""wire_gb_per_step: the bytes that crossed the link both ways in the
window, ``transfer_summary()``'s ``h2d_wire + d2h_wire``, a step, in GB
(a count: it repeats exactly). Layer: the transport."""


def read(w):
    if w.steps <= 0:
        return None
    return (w.wire["h2d_wire"] + w.wire["d2h_wire"]) / w.steps / 1e9
