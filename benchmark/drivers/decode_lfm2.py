"""Driver of the "decode_lfm2" traffic kind: S encrypted LFM2-MoE decoding
sessions advanced together, one token each a step, through the program's
device-resident client (`Lfm2TokenRunner.generate_tokens_streams`), each
session's state (conv state and KV cache) on the device from empty.

Set-up makes the weights from the seed (`benchmark/weights_lfm2.py`),
builds the program's CKKS context (`keys_s`) and its runner (rotation
keys, the device encode of every layer's diagonals, client weights:
`stage_s`), then warms up the step's shapes on a state of its own
(`warmup_steps`; a projection's first call runs eagerly, its second is
captured as a CUDA graph).  The window starts from an empty state and
feeds the ids of `benchmark/traffic.py`; each step's logits and the
client's selected experts are kept for the comparison, which runs once
the program's state is freed.

Its numbers (`NUMBERS`), against the float64 reference (`benchmark/
reference/lfm2.py`) on the same weights and ids from an empty state:
those of `benchmark/compare.py` (logit_err_median, logit_err_tail_max,
top_gap_max, logit_err_max: the same definitions, over every step and
stream; the configuration limits logit_err_max, every step, where RWKV's
limit the tail: an LFM2 step from an empty state is no worse
conditioned than a later one); route_margin_max, the largest amount by which the reference
scores an expert the program left out above one it took (0 where every
routing agrees; the reference follows the program's routing where it is
within the configuration's limit on this number, its own otherwise);
route_swaps, the count of such routings; coeff_headroom, the program's
largest decrypted coefficient over q0 / 2 (single-limb decryption wraps
at 1); and tf32_switches_on, read once the window has closed.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from ..compare import LOGIT_NUMBERS, TAIL_FROM, precision_switches
from ..reference.lfm2 import reference_logits
from ..roofline_lfm2 import lfm2_step_bound
from ..traffic import TokenIds
from ..weights import derive_seed
from ..weights_lfm2 import lfm2_dims, make_weights

__all__ = ["NUMBERS", "Driver", "compare_lfm2"]

NUMBERS = LOGIT_NUMBERS + ("route_margin_max", "route_swaps",
                           "coeff_headroom", "tf32_switches_on")


def compare_lfm2(weights: dict, ids, logits, routes, device, tie: float,
                 per_step: list | None = None) -> dict:
    """The logit numbers and route_margin_max / route_swaps of logits
    [T, S, vocab] and selected experts routes [T, S, n_moe, k] at ids
    [T, S], against the float64 reference run on device (taking the
    program's routing within `tie`).  per_step, where given, receives
    each step's (err [S], gap [S])."""
    ids = np.asarray(ids)
    if not len(ids):
        return {}
    ref, info = reference_logits(weights, ids, device, "float64",
                                 routes=routes, tie=tie)
    if not isinstance(logits, torch.Tensor):
        logits = torch.as_tensor(np.asarray(logits))
    got = logits.to(ref.device, torch.float64)
    centred = ref - ref.mean(-1, keepdim=True)
    err = torch.linalg.vector_norm(got - ref, dim=-1) \
        / torch.linalg.vector_norm(centred, dim=-1)            # [T, S]
    top = ref.gather(-1, got.argmax(-1, keepdim=True))[..., 0]
    gap = (ref.amax(-1) - top) / centred.pow(2).mean(-1).sqrt()
    if per_step is not None:
        per_step.extend(zip(err.tolist(), gap.tolist()))
    out = {"logit_err_median": float(err.median()),
           "top_gap_max": float(gap.max()),
           "logit_err_max": float(err.max()),
           "route_margin_max": info["route_margin_max"],
           "route_swaps": float(info["route_swaps"])}
    if len(ids) > TAIL_FROM:
        out["logit_err_tail_max"] = float(err[TAIL_FROM:].max())
    return out


def program_model(weights: dict):
    """The program's Lfm2Model over the benchmark's weight dict."""
    from fhe_spear_tpu_torch.models.lfm2 import Lfm2Model

    return Lfm2Model.from_weights(weights)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.ids = TokenIds(traffic, lfm2_dims(cfg)["vocab"], seed)
        self.streams = self.ids.streams
        self.logits: list = []
        self.routes: list = []
        self.runner = self.headroom = None
        # float32 with TF32 off, as the configuration states; cuDNN's
        # switch is on by torch's default (the program runs no cuDNN op)
        torch.backends.cudnn.allow_tf32 = False

    # -- set-up -----------------------------------------------------------

    def setup(self, span) -> None:
        from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
        from fhe_spear_tpu_torch.models.lfm2 import Lfm2TokenRunner

        cfg, ck = self.cfg, self.cfg["ckks"]
        with span("weights_s"):
            self.weights = make_weights(cfg, self.seed, self.device)
            self.model = program_model(self.weights)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        with span("keys_s"):
            self.ctx = CkksContext(
                CkksParams(ck["n"], num_limbs=ck["num_limbs"],
                           num_special=ck["num_special"],
                           scale_bits=ck["scale_bits"],
                           ntt_backend=ck["ntt_backend"]),
                seed=derive_seed(self.seed, 0) % (1 << 32),
                device=self.device)
        with span("stage_s"):
            self.runner = Lfm2TokenRunner(self.ctx, self.model,
                                          level=ck["level"],
                                          experts=cfg["experts_held"])
        with span("warmup_s"):
            state = self.runner.zero_state(self.streams)
            for t in range(int(self.traffic["warmup_steps"])):
                self.runner.generate_tokens_streams(
                    [int(i) for i in self.ids.warmup(t)], state)
        self.state = self.runner.zero_state(self.streams)

    # -- the window -------------------------------------------------------

    def step(self, t: int) -> None:
        """Step t of the window: one token for every stream; returns when
        the logits are on the host."""
        logits, self.state = self.runner.generate_tokens_streams(
            [int(i) for i in self.ids.ids(t)], self.state)
        self.logits.append(np.asarray(logits))
        self.routes.append(self.runner.last_routes)

    def counters(self) -> dict:
        """The program's K1/K2 launch counters {"ntt_fwd"/"ntt_inv":
        {(B, R, N): launches}} and its MoE counters {"moe":
        {"expert_matvecs", "routed_matvecs", "experts_ms"}} (the device
        time of the `moe.experts` spans)."""
        from fhe_spear_tpu_torch.core.ntt_cuda import NTT_FWD, NTT_INV
        from fhe_spear_tpu_torch.utils.profiling import MOE, MOE_TIMER

        return {"ntt_fwd": dict(NTT_FWD.by_shape),
                "ntt_inv": dict(NTT_INV.by_shape),
                "moe": dict(MOE, experts_ms=MOE_TIMER.read())}

    def step_bound(self) -> dict:
        return lfm2_step_bound(self.cfg, self.streams)

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        """Free the program's state (the runner, context, model and
        states), reading its decryption headroom first."""
        if self.runner is not None:
            self.headroom = self.runner.headroom()
        self.runner = self.ctx = self.model = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, steps: int) -> dict:
        """The comparison's numbers over the window's first `steps` steps,
        the switches read before the reference runs."""
        switches = precision_switches()
        if switches:
            print("TF32 switched on: " + ", ".join(switches),
                  file=sys.stderr, flush=True)
        tie = float(self.cfg.get("limits", {}).get("route_margin_max", 0.0))
        numbers = compare_lfm2(self.weights, self.ids.window(steps),
                               self.logits[:steps], self.routes[:steps],
                               self.device, tie)
        if self.headroom is not None:
            numbers["coeff_headroom"] = self.headroom
        numbers["tf32_switches_on"] = float(len(switches))
        return numbers
