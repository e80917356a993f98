"""step_p90_s: the 90th percentile of every step's seconds in the window
(nearest rank).  Host clock."""
import math


def read(w):
    if not w.times:
        return None
    times = sorted(w.times)
    return times[math.ceil(0.9 * len(times)) - 1]
