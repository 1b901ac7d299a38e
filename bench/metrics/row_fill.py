"""row_fill: the share of the fused calls' computed token rows that carry
a real token: the sum of decode rows and prefill tokens over the sum of
padded batch times chunk width, from the ``fused_step`` spans' arguments."""


def read(w):
    real = rows = 0
    for sp in w.spans:
        if sp.name == "fused_step" and sp.args:
            a = sp.args
            real += a["decode_rows"] + a["prefill_tokens"]
            rows += a["batch"] * a["chunk"]
    return 100.0 * real / rows if rows else None
