"""idle_share: the share of the traced window in which no operation ran on
the device (the union of its kernels, copies and memsets in the profiler's
trace), in percent."""


def read(w):
    if w.device is None or w.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - w.device["busy_s"] / w.device["window_s"])
