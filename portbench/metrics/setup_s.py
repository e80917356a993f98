"""setup_s: seconds from the process's start to the window's: imports,
inputs made from the seed, the session, kernel loads (and the first
run's build) and the warm-up steps.  Host clock."""


def read(w):
    return w.setup_s
