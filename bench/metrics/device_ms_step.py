"""device_ms_step: the median over the window's paged calls of the
call's ``device_ms`` argument: the device's time from the call's first
operation to its last, between two timing events the call records
inside its captured graph.  Traced runs; None where the program's call
spans carry no such argument."""

import numpy as np

CALLS = ("fused_step", "prefill_chunk", "paged_decode")


def read(w):
    ms = [sp.args["device_ms"] for sp in w.spans
          if sp.name in CALLS and sp.args and "device_ms" in sp.args]
    return float(np.median(ms)) if ms else None
