"""step_mfu (%), layer "Token step": the least time of one step's work
on the chip (`benchmark/roofline.step_bound`, from the configuration's
shapes and S alone) over the mean host-clock time of the traced run's
steps outside the profiled ones.  Moves step_ms."""


def read(rec):
    mean = rec["unprofiled_mean_s"]
    if not mean:
        return None
    return 100.0 * rec["step_bound"]["s"] / mean
