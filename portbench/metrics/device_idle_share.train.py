"""Share of the training call's wall time in which the device ran nothing (%).

1 − (device busy per call ÷ wall per call).  Busy time is the union of the
device records' intervals over the traced block of whole calls; the wall
per call is the window's, taken on the host clock without the profiler, so
the profiler's own host time does not count as idle.  Where the busy time
per call reaches the wall per call, the profiler has stretched the device
records past the unprofiled wall and the share cannot be told: nothing is
read."""


def read(trace):
    if not trace.traced_calls or not trace.calls or trace.busy_s <= 0:
        return None
    busy = trace.busy_s / trace.traced_calls
    wall = trace.wall_s / trace.calls
    if busy >= wall:
        return None
    return 100.0 * (1.0 - busy / wall)
