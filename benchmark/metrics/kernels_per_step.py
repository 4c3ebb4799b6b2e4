"""kernels_per_step (kernels/step), layer "Device": device kernels (not
memory copies or sets) in the trace per profiled step.  Moves step_ms."""


def read(rec):
    tr = rec["trace"]
    if not tr or not rec["profiled_steps"] or not tr["kernels"]:
        return None
    return tr["kernels"] / rec["profiled_steps"]
