"""The frozen reference against the program's own float64 oracle
(`generate_token_plaintext`) at tiny widths, over several steps of
carried state and two streams."""

import numpy as np
import torch

from benchmark.drivers.decode import _program_model
from benchmark.reference.rwkv7 import reference_logits
from benchmark.weights import make_weights

from .conftest import tiny_spec


def test_reference_equals_program_oracle():
    from fhe_spear_tpu_torch.models.rwkv7 import generate_token_plaintext

    cfg = tiny_spec("rwkv7-1.5b.s1")["config"]
    w = make_weights(cfg, 2**31 + 7, "cpu")
    model = _program_model(w, cfg)
    ids = np.random.default_rng(3).integers(0, cfg["vocab_size"], (6, 2))
    got = reference_logits(w, ids, "cpu")
    states = [model.zero_state() for _ in range(2)]
    for t in range(len(ids)):
        for s in range(2):
            lg, states[s] = generate_token_plaintext(model, int(ids[t, s]),
                                                     states[s])
            np.testing.assert_allclose(got[t, s], lg, rtol=1e-10,
                                       atol=1e-10)


def test_reference_precisions_differ_from_float64():
    """The control precisions compute what they say: TF32 rounds product
    inputs to a 10-bit mantissa, bfloat16 runs everything in bfloat16."""
    from benchmark.reference.rwkv7 import _round_tf32

    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, 3.0])
    assert _round_tf32(x).tolist() == [1.0, 1.0 + 2.0**-10, 3.0]
    cfg = tiny_spec("rwkv7-1.5b.s1")["config"]
    w = make_weights(cfg, 5, "cpu")
    ids = np.arange(4).reshape(4, 1)
    ref = reference_logits(w, ids, "cpu")
    for prec, lo, hi in (("tf32", 1e-6, 1e-2), ("bfloat16", 1e-4, 1e-1)):
        low = reference_logits(w, ids, "cpu", prec)
        rel = np.abs(low - ref).max() / np.abs(ref).max()
        assert lo < rel < hi, (prec, rel)
