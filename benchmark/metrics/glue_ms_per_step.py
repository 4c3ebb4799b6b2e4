"""glue_ms_per_step (ms), layer "Modular arithmetic and client float
math": device time of every kernel that is not K1/K2, a four-step
kernel, cuFFT or a memory copy or set (`benchmark/trace.kernel_class`
"glue"), per profiled step.  Moves step_ms."""


def read(rec):
    tr = rec["trace"]
    if not tr or not rec["profiled_steps"] or "glue" not in tr["device_s"]:
        return None
    return 1e3 * tr["device_s"]["glue"] / rec["profiled_steps"]
