"""stage_s (s), layer "Server staging": the benchmark's span around the
construction of the program's `DeviceTokenRunner` (rotation keys, host
pre-encode of every block's diagonals, upload, client weights and
tables).  Moves setup_s."""


def read(rec):
    return rec["spans"].get("stage_s")
