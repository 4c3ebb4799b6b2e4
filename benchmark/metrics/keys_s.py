"""keys_s (s), layer "CKKS engine set-up": the benchmark's span around
the program's `CkksContext(...)` (primes, NTT tables, secret and
relinearisation keys).  Moves setup_s."""


def read(rec):
    return rec["spans"].get("keys_s")
