"""mfu: the model FLOPs of the window's real tokens (``roofline.row_flops``
of every fused call's rows) over the steps' wall seconds times the card's
bf16 peak, in percent.  Traced runs."""

from bench.roofline import PEAK_FLOPS, row_flops


def read(w):
    cfg = w.cell.config
    flops = sum(row_flops(cfg, s, n, lg) for st in w.steps if st.rows
                for s, n, lg in st.rows)
    wall = sum(st.t1 - st.t0 for st in w.steps)
    if flops <= 0 or wall <= 0:
        return None
    return 100.0 * flops / (wall * PEAK_FLOPS[cfg["dtype"]])
