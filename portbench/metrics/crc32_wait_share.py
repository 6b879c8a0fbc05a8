"""crc32_wait_share: the share of the window in which the caller waited
on a job that was digesting (crc32) a unit, ``Lanes.crc_wait_s`` over
the window (``stats()["lanes"]["crc_wait_s"]``). Layer: the host store
and its digest."""


def read(w):
    if w.seconds <= 0:
        return None
    return 100.0 * w.counters["lanes.crc_wait_s"] / w.seconds
