"""ntt_launches_per_step (launches/step), layer "BSGS matvec and
keyswitch": K1 + K2 launches over the whole traced window, from the
program's NTT_FWD / NTT_INV counters, per step.  Moves step_ms."""


def read(rec):
    n = sum(sum(v.values()) for k, v in rec["counters_window"].items()
            if k in ("ntt_fwd", "ntt_inv"))
    return n / rec["steps"] if n and rec["steps"] else None
