"""Driver of the "fullenc" traffic kind: requests served by the program's
fully-encrypted FFN chain (`FullyEncryptedFfn`), every block on the
ciphertext and nothing decrypted between blocks.

Set-up makes the weights and the calibration input from the seed and
runs the program's magnitude calibration (`calibrate_magnitude`; the
`weights_s` span), builds the program's CKKS context (primes, secret and
relinearisation keys: `keys_s`) and its chain evaluator with its rotation
keys, pre-encodes every block's diagonals on the host at the level the
block is consumed at (`fe_level_schedule`) and stages them on the device
(`stage_s`), then warms up on the warm-up vectors (`warmup_s`).

A request is one input vector of `benchmark/vectors.py`: encrypted at
the top level (`encrypt_replicated`), run through every staged block by
`FullyEncryptedFfn.__call__`, decrypted to the host (`decrypt_vec`).  A
step serves the S requests of one step one after another.  The window
stages nothing from the host and decrypts nothing between blocks; it
does not call `run_fully_encrypted`, whose per-block decryption and
oracle check and per-pass host staging are verification, not the served
path.

Its numbers (`NUMBERS`), from every request of the window against the
plain float64 chain (`benchmark/reference/ffn_chain.py`), worked out
once the program's state is freed:
  out_err_median   the median over requests of ||y - y_ref|| / ||y_ref||;
  out_err_max      the largest of that error;
  out_abs_err_max  the largest |y - y_ref| of any coordinate;
  tf32_switches_on the count of torch switches that let float32 products
                   run in TF32, read once the window has closed.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from ..compare import precision_switches
from ..ffn_weights import make_ffn_weights
from ..reference.ffn_chain import reference_outputs
from ..roofline_fullenc import fullenc_step_bound
from ..vectors import InputVectors
from ..weights import derive_seed

__all__ = ["NUMBERS", "Driver", "compare_outputs"]

NUMBERS = ("out_err_median", "out_err_max", "out_abs_err_max",
           "tf32_switches_on")


def compare_outputs(weights: dict, xs, outputs, device) -> dict:
    """The chain's numbers (all but tf32_switches_on) for the outputs
    [T, S, D] (numpy or tensor) of inputs xs [T, S, D], against the
    float64 reference run on device."""
    xs = np.asarray(xs)
    if not xs.size:
        return {}
    d = xs.shape[-1]
    ref = reference_outputs(weights, xs.reshape(-1, d), device)
    if not isinstance(outputs, torch.Tensor):
        outputs = torch.as_tensor(np.asarray(outputs))
    got = outputs.to(ref.device, torch.float64).reshape(-1, d)
    err = (torch.linalg.vector_norm(got - ref, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1))
    return {"out_err_median": float(err.median()),
            "out_err_max": float(err.max()),
            "out_abs_err_max": float((got - ref).abs().max())}


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.inputs = InputVectors(traffic, cfg["hidden_size"], seed)
        self.streams = self.inputs.streams
        self.outputs: list = []
        # TF32 off, as the configuration states; cuDNN's switch is on by
        # torch's default (the program runs no cuDNN op)
        torch.backends.cudnn.allow_tf32 = False

    # -- set-up -----------------------------------------------------------

    def setup(self, span) -> None:
        from fhe_spear_tpu_torch.ckks import CkksContext, CkksParams
        from fhe_spear_tpu_torch.models.fully_encrypted import (
            FullyEncryptedFfn, calibrate_magnitude, fe_level_schedule,
            pre_encode_blocks)

        cfg, ck = self.cfg, self.cfg["ckks"]
        with span("weights_s"):
            self.weights = make_ffn_weights(cfg, self.seed, self.device)
            w_keys, w_vals = calibrate_magnitude(
                self.weights["w_key"], self.weights["w_val"],
                self.weights["x_cal"])
            if self.device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        with span("keys_s"):
            self.ctx = CkksContext(
                CkksParams(ck["n"], num_limbs=ck["num_limbs"],
                           num_special=ck["num_special"],
                           scale_bits=ck["scale_bits"], dnum=ck["dnum"],
                           ntt_backend=ck["ntt_backend"]),
                seed=derive_seed(self.seed, 0) % (1 << 32),
                device=self.device)
        with span("stage_s"):
            self.eng = FullyEncryptedFfn(
                self.ctx, cfg["hidden_size"], cfg["intermediate_size"],
                stage_mode=ck["staging"], width=ck["width"])
            levels = fe_level_schedule(ck["num_limbs"],
                                       cfg["num_hidden_layers"],
                                       width=ck["width"])
            if levels != ck["levels"]:
                raise ValueError(f"the program schedules the blocks at "
                                 f"levels {levels}, the configuration "
                                 f"states {ck['levels']}")
            hosts = pre_encode_blocks(self.eng, w_keys, w_vals,
                                      levels=levels)
            self.staged = [self.eng.load_block(h, lv)
                           for h, lv in zip(hosts, levels)]
            del hosts, w_keys, w_vals
        with span("warmup_s"):
            for t in range(int(self.traffic["warmup_steps"])):
                for x in self.inputs.warmup(t):
                    self._serve(x)

    def _serve(self, x: np.ndarray) -> np.ndarray:
        """One request: encrypt x, every block, decrypt."""
        ctx = self.ctx
        ct = ctx.encrypt_replicated(
            x, scale=ctx.scale ** 2 if self.eng.width == 2 else None)
        for staged in self.staged:
            ct = self.eng(ct, staged)
        return ctx.decrypt_vec(ct, x.shape[-1])

    # -- the window -------------------------------------------------------

    def step(self, t: int) -> None:
        """Step t of the window: the S requests of step t; returns when
        their outputs are on the host."""
        self.outputs.append(np.stack([self._serve(x)
                                      for x in self.inputs.step(t)]))

    def counters(self) -> dict:
        """The program's K1/K2 launch counters: {"ntt_fwd"/"ntt_inv":
        {(B, R, N): launches}}."""
        from fhe_spear_tpu_torch.core.ntt_cuda import NTT_FWD, NTT_INV

        return {"ntt_fwd": dict(NTT_FWD.by_shape),
                "ntt_inv": dict(NTT_INV.by_shape)}

    def step_bound(self) -> dict:
        return fullenc_step_bound(self.cfg, self.streams)

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        """Free the program's state (the staged blocks, evaluator and
        context)."""
        self.staged = self.eng = self.ctx = None
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
        numbers = compare_outputs(self.weights, self.inputs.window(steps),
                                  self.outputs[:steps], self.device)
        numbers["tf32_switches_on"] = float(len(switches))
        return numbers
