"""out_tok_s: output tokens served in the window over its seconds."""


def read(w):
    return w.tokens / (w.close - w.t0)
