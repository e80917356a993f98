"""idle_share: percent of the steps' time in which no kernel, copy or
memset ran on the card: 1 - the device's busy time over the traced steps
(the profiler's trace) / the host-clock seconds of as many steps run just
before them without the profiler, whose tracing of each node of a
replayed CUDA graph slows the host that launches them."""


def read(w):
    p = w.profile
    if p is None or p.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.untraced_s)
