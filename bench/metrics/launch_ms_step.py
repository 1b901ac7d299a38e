"""launch_ms_step: the median over the window's replayed calls of the
engine's ``graph/replay`` span, in ms: the host's part of a captured
call (the shape key, the pointer check, staging the host arrays into the
static inputs, and ``graph.replay()``'s launch).  Traced runs (engine
telemetry on); None where the program records no such span."""

import numpy as np


def read(w):
    durs = [sp.dur for sp in w.spans if sp.name == "graph/replay"]
    return float(np.median(durs)) * 1e3 if durs else None
