"""link_mb_per_step: megabytes (1e6 B) the runtime moved across the host
link per step in the window: placements in and out and operands streamed
for one call (``bytes_in + bytes_out + transient_bytes``); an exact
count."""


def read(w):
    if not w.steps:
        return None
    c = w.counters
    moved = c["bytes_in"] + c["bytes_out"] + c["transient_bytes"]
    return moved / w.steps / 1e6
