"""caller_wait_share: the share of the window in which the engine's
caller (the thread that issues the sweeps) sat blocked on the host
threads' copy and digest jobs, ``Lanes.wait_s`` over the window
(``AsyncExecutor.stats()["lanes"]["host_wait_s"]``). Layer: the engine."""


def read(w):
    if w.seconds <= 0:
        return None
    return 100.0 * w.counters["lanes.host_wait_s"] / w.seconds
