"""device_idle (%), layer "Device": the share of the profiled steps'
wall time (host clock) in which no device operation ran (the union of
the trace's device intervals).  Moves step_ms."""


def read(rec):
    tr, wall = rec["trace"], rec["profiled_wall_s"]
    if not tr or not wall:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / wall)
