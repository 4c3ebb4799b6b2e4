"""expert_matvecs_per_step (matvecs/step), layer "MoE experts": the
server's expert matvecs over the whole traced window, from the program's
`MOE` counter (every held expert on every token, up and down, whatever
the routing), per step; null where the program has no such counter.
Moves step_ms."""


def read(rec):
    n = rec["counters_window"].get("moe", {}).get("expert_matvecs")
    return n / rec["steps"] if n and rec["steps"] else None
