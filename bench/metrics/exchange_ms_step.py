"""exchange_ms_step: the device's ms a step in the exchange of pool pages
(the gather into the anchor's staging region before the call's layers,
and the write-back after them): the ``exchange_ms`` argument of the
window's paged calls, summed, over the window's steps.  Traced runs;
None where the program's call spans carry no such argument."""

CALLS = ("fused_step", "prefill_chunk", "paged_decode")


def read(w):
    ms = [sp.args["exchange_ms"] for sp in w.spans
          if sp.name in CALLS and sp.args and "exchange_ms" in sp.args]
    if not ms or not w.steps:
        return None
    return sum(ms) / len(w.steps)
