"""dispatch_us_per_call: microseconds the runtime spends per intercepted
call to decide, stage and enqueue it (``RoutineStats.seconds``, host time
with ``sync`` off), over the window's calls."""


def read(w):
    calls = w.counters.get("calls", 0)
    return w.counters["seconds"] / calls * 1e6 if calls else None
