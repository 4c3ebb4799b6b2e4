"""Per-metric readers: `read(rec)` -> a number, or None where the run
has nothing to read."""
