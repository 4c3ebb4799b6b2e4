"""setup_s (s): process start to the first timed step, on the host's
clock: imports, CUDA start-up, weights, keys, staging, warm-up and any
build of the program's kernels.  Moves itself (end-to-end)."""


def read(rec):
    return rec["setup_s"]
