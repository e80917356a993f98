"""step_s: the window's seconds over the steps completed in it; each
step ends in a host read of its result.  Host clock."""


def read(w):
    return w.window_s / w.steps if w.steps else None
