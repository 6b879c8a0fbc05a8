"""h2d_busy_share: the share of the window in which the engine's H2D
stream was busy with its copies, ``Lanes.busy_s()["h2d"]`` (CUDA events
around each copy) over the window. Layer: the transport."""


def read(w):
    busy = w.counters.get("busy.h2d")
    if busy is None or busy <= 0 or w.seconds <= 0:
        return None
    return 100.0 * busy / w.seconds
