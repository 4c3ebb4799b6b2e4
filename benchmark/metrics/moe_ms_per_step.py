"""moe_ms_per_step (ms), layer "MoE experts": device time between the
edges of the program's `moe.experts` spans (CUDA events at each span's
edges, read after the steps: the expert round trips, encrypt to decrypt,
and the client's gates between them), from its counters read across
exactly the profiled steps, per profiled step; null where the program
has no such timer.  Moves step_ms."""


def read(rec):
    counts = rec["counters_profiled"]
    ms = (counts or {}).get("moe", {}).get("experts_ms")
    return ms / rec["profiled_steps"] if ms and rec["profiled_steps"] \
        else None
