"""staged_mb_step: MB (1e6 bytes) of pool pages the exchange staged from
the pool shard into the anchor's region a step: the counter
``fastpath/gather_d2d_bytes`` over the window, over its steps."""


def read(w):
    if not w.steps:
        return None
    return w.counters["gather_d2d_bytes"] / len(w.steps) / 1e6
