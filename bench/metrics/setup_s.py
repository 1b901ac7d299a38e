"""setup_s: seconds from the process's start to the window's start
(imports, kernel libraries, weights, engine, warm-up and its captures)."""


def read(w):
    return w.setup_s
