"""Seeded random RWKV-7 weights at a configuration's widths, made on the
device in a few large draws and handed to both sides as one plain dict.

The magnitudes follow the seeded generator that the program's own tests
use (uniform draws with the stated standard deviations): projections
[in, out] at 1/sqrt(in), layer-norm gains in [0.6, 1.4], token-mix
coefficients in [0, 1], LoRA biases at 0.5.  The LoRA ranks are the
configuration's (`lora`), so a block has the published shapes.  Every
tensor is float64, the type the program's host side serves them in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["derive_seed", "dims", "block_layout", "make_weights"]


def derive_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (`tag`) of the run's --seed; any whole
    number is taken (negative ones by their value modulo 2^64)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(tag)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def dims(cfg: dict) -> dict:
    """The sizes of a configuration file under short names: d, f,
    head_size, vocab, blocks, lora {decay, a, v, gate}."""
    return {"d": cfg["hidden_size"], "f": cfg["intermediate_size"],
            "head_size": cfg["head_dim"], "vocab": cfg["vocab_size"],
            "blocks": cfg["num_hidden_layers"],
            "lora": {"decay": cfg["decay_low_rank_dim"],
                     "a": cfg["a_low_rank_dim"],
                     "v": cfg["v_low_rank_dim"],
                     "gate": cfg["gate_low_rank_dim"]}}


def block_layout(cfg: dict) -> list:
    """(name, shape, low, high) of one block's tensors, drawn uniformly."""
    m = dims(cfg)
    d, f, hs, lora = m["d"], m["f"], m["head_size"], m["lora"]
    s3 = math.sqrt(3.0)

    def sd(shape, s, loc=0.0):
        return (shape, loc - s * s3, loc + s * s3)

    def mat(i, o):
        return sd((i, o), 1.0 / math.sqrt(i))

    out = []
    for nm in ("ln1", "ln2", "ln_x"):
        out += [(nm + "_w", (d,), 0.6, 1.4), (nm + "_b",) + sd((d,), 0.1)]
    out += [("x_" + nm, (d,), 0.0, 1.0)
            for nm in ("r", "k", "v", "g", "w", "a", "k_ffn")]
    for nm, rank in (("w", lora["decay"]), ("a", lora["a"]),
                     ("v", lora["v"])):
        out += [(nm + "0",) + sd((d,), 0.5), (nm + "1",) + mat(d, rank),
                (nm + "2",) + mat(rank, d)]
    out += [("g1",) + mat(d, lora["gate"]), ("g2",) + mat(lora["gate"], d),
            ("k_k",) + sd((d,), 0.5), ("k_a", (d,), 0.0, 1.0),
            ("r_k",) + sd((d // hs, hs), 0.5)]
    out += [(nm,) + mat(d, d) for nm in ("W_r", "W_k", "W_v", "W_o")]
    out += [("W_key_ffn",) + mat(d, f), ("W_val_ffn",) + mat(f, d)]
    return out


def _draw(layout, gen, device) -> dict:
    """One uniform draw on the device for every tensor of layout, mapped
    to each tensor's range, brought to the host as float64 numpy views."""
    sizes = [math.prod(shape) for _, shape, _, _ in layout]
    per = lambda vals: torch.repeat_interleave(
        torch.tensor(vals, dtype=torch.float64, device=device),
        torch.tensor(sizes, device=device))
    u = torch.rand(sum(sizes), generator=gen, dtype=torch.float64,
                   device=device)
    u.mul_(per([b - a for _, _, a, b in layout]))
    u.add_(per([a for _, _, a, _ in layout]))
    flat = u.cpu().numpy()
    del u
    out, at = {}, 0
    for n, (name, shape, _, _) in zip(sizes, layout):
        out[name] = flat[at:at + n].reshape(shape)
        at += n
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The whole model from seed: {"blocks": [dict per block], "emb",
    "head_w", "ln0_w", "ln0_b", "ln_out_w", "ln_out_b", "head_size"}."""
    m = dims(cfg)
    d, vocab = m["d"], m["vocab"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 3))
    layout = block_layout(cfg)
    blocks = [_draw(layout, gen, device) for _ in range(m["blocks"])]
    s3 = math.sqrt(3.0)
    top = _draw([("emb", (vocab, d), -s3, s3),
                 ("head_w", (d, vocab), -s3 / math.sqrt(d), s3 / math.sqrt(d)),
                 ("ln0_w", (d,), 0.6, 1.4), ("ln0_b", (d,), -0.1 * s3,
                                             0.1 * s3),
                 ("ln_out_w", (d,), 0.6, 1.4), ("ln_out_b", (d,), -0.1 * s3,
                                                0.1 * s3)], gen, device)
    return dict(top, blocks=blocks, head_size=m["head_size"])

