"""host_ms_step: the median over the window's steps of the engine's
``step`` span less the ``fused_step`` span inside it (admission, the
packer, sampling, the dispatcher; the span closes after the device
finished the call).  Traced runs (engine telemetry on)."""

import numpy as np


def read(w):
    steps = sorted((sp.ts, sp.ts + sp.dur) for sp in w.spans
                   if sp.name == "step")
    calls = sorted((sp.ts, sp.dur) for sp in w.spans
                   if sp.name == "fused_step")
    out, j = [], 0
    for s, e in steps:
        inner = 0.0
        while j < len(calls) and calls[j][0] < e:
            if calls[j][0] >= s:
                inner += calls[j][1]
            j += 1
        out.append(e - s - inner)
    return float(np.median(out)) * 1e3 if out else None
