"""Driver of the "decode" traffic kind: S encrypted RWKV-7 generation
sessions advanced together, one token each a step, through the program's
device-resident client (`DeviceTokenRunner.generate_tokens_streams`).

Set-up makes the weights from the seed, builds the program's CKKS
context (primes, secret and relinearisation keys: the `keys_s` span) and
its runner (rotation keys and the host pre-encode of every block's
diagonals, staged on the device: the `stage_s` span), then warms up the
step's shapes on zero states.  The window starts from zero states and
feeds the ids of `benchmark/traffic.py`; each step's logits are kept for
the comparison, which runs once the program's state is freed.

Its numbers (`NUMBERS`) are those of `benchmark/compare.compare_logits`
and `tf32_switches_on`, the count of torch switches that let float32
products run in TF32, read once the window has closed: the configuration
states float32 with TF32 off.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from ..compare import LOGIT_NUMBERS, compare_logits, precision_switches
from ..roofline import step_bound
from ..traffic import TokenIds
from ..weights import derive_seed, dims, make_weights

__all__ = ["NUMBERS", "Driver"]

NUMBERS = LOGIT_NUMBERS + ("tf32_switches_on",)


def _program_model(weights: dict, cfg: dict):
    """The program's RwkvModel over the benchmark's weight arrays."""
    from fhe_spear_tpu_torch.models.rwkv7 import RwkvBlockWeights, RwkvModel

    m = dims(cfg)
    hs = m["head_size"]
    blocks = [RwkvBlockWeights(block_idx=i, d=m["d"], f=m["f"],
                               n_head=m["d"] // hs, head_size=hs, **b)
              for i, b in enumerate(weights["blocks"])]
    return RwkvModel(blocks=blocks, emb=weights["emb"],
                     head_w=weights["head_w"], ln_out_w=weights["ln_out_w"],
                     ln_out_b=weights["ln_out_b"], ln0_w=weights["ln0_w"],
                     ln0_b=weights["ln0_b"])


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.ids = TokenIds(traffic, dims(cfg)["vocab"], seed)
        self.streams = self.ids.streams
        self.logits: list = []
        # float32 with TF32 off, as the configuration states; cuDNN's
        # switch is on by torch's default (the program runs no cuDNN op)
        torch.backends.cudnn.allow_tf32 = False

    # -- set-up -----------------------------------------------------------

    def setup(self, span) -> None:
        from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
        from fhe_spear_tpu_torch.models.device_client import \
            DeviceTokenRunner

        cfg, ck = self.cfg, self.cfg["ckks"]
        with span("weights_s"):
            self.weights = make_weights(cfg, self.seed, self.device)
            self.model = _program_model(self.weights, cfg)
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
            self.runner = DeviceTokenRunner(self.ctx, self.model,
                                            level=ck["level"])
        with span("warmup_s"):
            states = [self.model.zero_state() for _ in range(self.streams)]
            for t in range(int(self.traffic["warmup_steps"])):
                _, states = self.runner.generate_tokens_streams(
                    [int(i) for i in self.ids.warmup(t)], states)
        self.states = [self.model.zero_state() for _ in range(self.streams)]

    # -- the window -------------------------------------------------------

    def step(self, t: int) -> None:
        """Step t of the window: one token for every stream; returns when
        the logits are on the host."""
        logits, self.states = self.runner.generate_tokens_streams(
            [int(i) for i in self.ids.ids(t)], self.states)
        self.logits.append(np.asarray(logits))

    def counters(self) -> dict:
        """The program's K1/K2 launch counters: {"ntt_fwd"/"ntt_inv":
        {(B, R, N): launches}}."""
        from fhe_spear_tpu_torch.core.ntt_cuda import NTT_FWD, NTT_INV

        return {"ntt_fwd": dict(NTT_FWD.by_shape),
                "ntt_inv": dict(NTT_INV.by_shape)}

    def step_bound(self) -> dict:
        return step_bound(self.cfg, self.streams)

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        """Free the program's state (the runner, context and model)."""
        self.runner = self.ctx = self.model = self.states = None
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
        numbers = compare_logits(self.weights, self.ids.window(steps),
                                 self.logits[:steps], self.device)
        numbers["tf32_switches_on"] = float(len(switches))
        return numbers
