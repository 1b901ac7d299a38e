"""captures_in_window: the shapes the engine's paged calls saw first in
the window (each a CUDA graph captured there); the warm-up missed them."""


def read(w):
    return float(w.counters["captures"])
