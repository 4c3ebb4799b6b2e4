"""The comparison that decides `correct`, and the pieces a driver builds
its numbers from.

A driver's `check()` returns its numbers by name, and its module lists
them in `NUMBERS`.  The configuration's `limits` give a limit to some of
them; `verdict` holds every number that has a limit against it, and
prints the others.  A driver of a new kind of traffic brings its own
numbers; this module needs no edit for it.

For logits (`compare_logits`), the program's logits of every step of the
window are held against the plain reference's (`benchmark/reference/
rwkv7.py`, float64, TF32 off) on the same weights and the same ids from
zero state, step by step with the state each side carries itself.  For
each step and stream:

  err   ||program - ref|| / ||ref - mean(ref)|| over the vocabulary: the
        relative error of the whole logit vector.
  gap   (max(ref) - ref[argmax(program)]) / std(ref): how far below the
        reference's best the program's own first token lies, in units of
        the logits' spread (0 where they agree).

Its numbers: `logit_err_median`, the median of err over every step and
stream (steady from seed to seed); `logit_err_tail_max`, the largest err
from step TAIL_FROM on, over every stream: the worst step once the state
holds more than the first tokens' outer products; `top_gap_max`, the
widest gap; and `logit_err_max`, the largest err of any step.  The first
steps from zero state are ill-conditioned in every precision (a head
whose r.k nearly cancels is rescaled by its GroupNorm), so their err
swings several-fold from seed to seed; a fault in them carries into the
state that the later steps read.

`precision_switches` names the torch switches that let float32 products
run in TF32, for a configuration that states float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.rwkv7 import reference_logits

__all__ = ["TAIL_FROM", "LOGIT_NUMBERS", "compare_logits",
           "precision_switches", "verdict"]

TAIL_FROM = 2
LOGIT_NUMBERS = ("logit_err_median", "logit_err_tail_max", "top_gap_max",
                 "logit_err_max")


def compare_logits(weights: dict, ids: np.ndarray, logits, device,
                   per_step: list | None = None) -> dict:
    """The numbers of LOGIT_NUMBERS for the program's logits [T, S, vocab]
    (a sequence of [S, vocab] arrays) at ids [T, S], against the float64
    reference run on device; `logit_err_tail_max` only where the window
    reached step TAIL_FROM.  per_step, where given, receives each step's
    (err [S], gap [S])."""
    errs, gaps = [], []

    def on_step(t, ref):
        got = torch.as_tensor(np.asarray(logits[t]), device=ref.device
                              ).to(torch.float64)
        centred = ref - ref.mean(-1, keepdim=True)
        err = torch.linalg.vector_norm(got - ref, dim=-1) \
            / torch.linalg.vector_norm(centred, dim=-1)
        top = ref.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
        gap = (ref.amax(-1) - top) / centred.pow(2).mean(-1).sqrt()
        errs.append(err.tolist())
        gaps.extend(gap.tolist())
        if per_step is not None:
            per_step.append((err.tolist(), gap.tolist()))

    if not len(ids):
        return {}
    reference_logits(weights, ids, device, "float64", on_step=on_step)
    out = {"logit_err_median": float(np.median(errs)),
           "top_gap_max": float(np.max(gaps)),
           "logit_err_max": float(np.max(errs))}
    if len(errs) > TAIL_FROM:
        out["logit_err_tail_max"] = float(np.max(errs[TAIL_FROM:]))
    return out


def precision_switches() -> list:
    """The names of the torch switches that now let float32 products run
    in TF32 (or lower): the legacy flags and, where this torch has it,
    the newer `fp32_precision` setting.  A switch that cannot be read
    because the two interfaces were mixed counts as on."""
    b = torch.backends
    reads = (
        ("float32_matmul_precision",
         lambda: torch.get_float32_matmul_precision() != "highest"),
        ("cuda.matmul.allow_tf32", lambda: b.cuda.matmul.allow_tf32),
        ("cudnn.allow_tf32", lambda: b.cudnn.allow_tf32),
        ("cuda.matmul.fp32_precision",
         lambda: b.cuda.matmul.fp32_precision == "tf32"),
        ("fp32_precision", lambda: b.fp32_precision == "tf32"),
    )
    on = []
    for name, read in reads:
        try:
            set_on = bool(read())
        except AttributeError:            # not in this version of torch
            continue
        except RuntimeError:              # legacy and new interface mixed
            set_on = True
        if set_on:
            on.append(name)
    return on


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over every number that `limits`
    gives a limit for, in the limits' order: correct when there is one
    and every such number is there and at most its limit (a NaN or a
    missing number is not)."""
    rows = [(k, numbers.get(k), lim) for k, lim in limits.items()]
    ok = bool(rows) and all(v is not None and v == v and v <= lim
                            for _, v, lim in rows)
    return ok, rows
