"""b1_roofline: B1's least time (``roofline.b1_bound`` of each traced fused
call's rows, once per layer) over B1's device time (its kernels in the
profiler's trace), in percent.  Traced runs; nothing where no B1 kernel
ran."""

from bench.roofline import b1_bound

B1_KERNELS = ("paged_prefill", "paged_decode_tma")


def read(w):
    if w.device is None:
        return None
    dev = sum(s for k, s in w.device["kernels"].items()
              if any(n in k for n in B1_KERNELS))
    cfg, eng = w.cell.config, w.cell.spec["engine"]
    Hkv = cfg["n_kv_heads"]
    bound = 0.0
    for st in w.traced_steps:
        if not st.rows:
            continue
        t, _, _, _ = b1_bound(st.batch, Hkv, st.chunk,
                              cfg["n_heads"] // Hkv, cfg["head_dim"],
                              eng["page_size"],
                              [s + n for s, n, _ in st.rows],
                              [s for s, _, _ in st.rows], cfg["dtype"])
        bound += t * cfg["n_layers"]
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
