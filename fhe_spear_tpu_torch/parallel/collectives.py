"""Rank groups, the rank launcher, and exact collectives over
`torch.distributed`.

Counterpart of `fhe_spear_tpu/parallel/collectives.py`.  The reference
runs one process over a device mesh (`shard_map`); the port runs one
process per rank (SPMD).  Every rank runs the same program from the same
seeds, so contexts, keys and ciphertexts are replicated bit for bit, and
only the sharded operands (giant groups, limb rows, key rows, block spans)
differ between ranks.

  * `RankGroup` is the handle a rank function receives: process group,
    rank, size, device and backend, and the bytes its collectives moved.
  * `run_ranks` spawns the ranks, initialises them over a `FileStore` in a
    temporary directory (no TCP port), returns each rank's result, and on
    its deadline terminates every child and raises.
  * Collectives move int64 only: gloo has no uint32 `all_reduce`, and the
    port carries residues as int64 anyway.  `psum_mod` is one int64
    `all_reduce` of canonical residues and one `% p`: the sum of `size`
    residues below 2^31 stays below 2^63, so it gives the words of the
    reference's 16-bit split (whose Montgomery constant `make_shift16_const`
    exists only because its psum is uint32, and is not ported).
  * A group of one rank still runs every collective (a world of one NCCL
    rank shows that the card's backend takes them), except `ring_shift`,
    which returns its input.
  * With the gloo backend and tensors on the card, each collective stages
    through the host explicitly (one `.cpu()` in, one `.to(device)` out)
    and counts the bytes; on NCCL tensors stay on the device.  The backend
    is never switched silently.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["RankGroup", "run_ranks", "rank_device", "psum_mod", "all_gather",
           "all_gather_rows", "all_to_all", "ring_shift"]


class RankGroup:
    """One rank's view of its group.  `stats` counts the collectives this
    rank took part in, the bytes it put into them, and the bytes it staged
    through the host (gloo with tensors on the card)."""

    def __init__(self, pg, rank: int, size: int, device, backend: str):
        self.pg = pg
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.stats = {"calls": 0, "bytes": 0, "host_bytes": 0}

    @property
    def staged(self) -> bool:
        """True where collectives go through the host (gloo on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor as it enters a collective: int64 (float32 for the
        pipeline's residual stream), contiguous, on the host when staged."""
        if x.dtype != torch.int64 and x.dtype != torch.float32:
            raise TypeError(f"collectives move int64 or float32, not "
                            f"{x.dtype}")
        self.stats["calls"] += 1
        self.stats["bytes"] += x.numel() * x.element_size()
        if self.staged:
            self.stats["host_bytes"] += x.numel() * x.element_size()
            return x.cpu().contiguous()
        return x.contiguous()

    def _back(self, y: torch.Tensor) -> torch.Tensor:
        if self.staged:
            self.stats["host_bytes"] += y.numel() * y.element_size()
            return y.to(self.device)
        return y


def rank_device(backend: str, device, rank: int, size: int) -> torch.device:
    """The device of a rank: NCCL puts rank r on cuda:r (and raises without
    enough cards); gloo on the card puts every rank on cuda:0; device="cpu"
    keeps every rank on the CPU (gloo only)."""
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if torch.cuda.device_count() < size:
            raise RuntimeError(f"nccl with {size} ranks needs {size} cards, "
                               f"this host shows {torch.cuda.device_count()}")
        return torch.device("cuda", rank)
    if backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        return torch.device("cuda", 0)
    return torch.device("cpu")


def _child(rank, fn, size, backend, device, store_path, timeout_s, threads,
           args, results):
    """Body of one spawned rank: join the group, run fn, put its result."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(backend, device, rank, size)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
        group = RankGroup(dist.group.WORLD, rank, size, dev, backend)
        out = fn(group, *args)
        results.put((rank, True, out))
    except BaseException:                       # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str = "gloo", device="cuda",
              timeout_s: float = 600.0, *args, threads: int | None = None):
    """Run fn(group, *args) in `world_size` spawned ranks; returns their
    results in rank order.  fn and its results must pickle (fn by import
    path: a module-level function of this package).  A rank that raises
    fails the run with its traceback; on the deadline every child is
    terminated and TimeoutError is raised.  threads: torch intra-op
    threads of each rank (None leaves torch's default)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="fhe_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_child, daemon=True,
            args=(r, fn, world_size, backend, device, store, timeout_s,
                  threads, args, results)) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got: dict = {}
        try:
            dead_since = None
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks({fn.__name__}): ranks "
                        f"{sorted(set(range(world_size)) - set(got))} gave no "
                        f"result within {timeout_s:.0f}s")
                try:
                    rank, ok, out = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    # a rank that died without a result (a crash in native
                    # code) fails the run once its queue had time to drain
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        dead_since = dead_since or time.monotonic()
                        if time.monotonic() - dead_since > 2.0:
                            raise RuntimeError(
                                f"run_ranks({fn.__name__}): rank {dead[0]} "
                                f"exited with code {procs[dead[0]].exitcode} "
                                "and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks({fn.__name__}): rank "
                                       f"{rank} failed:\n{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            results.close()
    return [got[r] for r in range(world_size)]


# -- collectives (int64) -----------------------------------------------------


def psum_mod(x: torch.Tensor, p: torch.Tensor, group: RankGroup
             ) -> torch.Tensor:
    """Exact modular all-reduce sum of canonical residues x [..., l, N]
    (int64, each < p < 2^31) over the group: one int64 all_reduce and one
    `% p` ([l, 1] moduli)."""
    y = group._out(x)
    if y is x:
        y = y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group.pg)
    return group._back(y) % p


def all_gather(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """[...] from every rank -> [size, ...] in rank order (equal shapes)."""
    y = group._out(x)
    parts = [torch.empty_like(y) for _ in range(group.size)]
    dist.all_gather(parts, y, group=group.pg)
    return group._back(torch.stack(parts))


def all_gather_rows(x: torch.Tensor, group: RankGroup, counts=None
                    ) -> torch.Tensor:
    """Concatenate every rank's rows [..., r_i, N] along the row axis (-2),
    in rank order.  counts: the row count of each rank where they differ
    (the rows are padded to the largest for the gather)."""
    if counts is None:
        counts = [x.shape[-2]] * group.size
    assert x.shape[-2] == counts[group.rank], (x.shape, counts)
    m = max(counts)
    if x.shape[-2] < m:
        pad = x.new_zeros(x.shape[:-2] + (m - x.shape[-2], x.shape[-1]))
        x = torch.cat([x, pad], dim=-2)
    g = all_gather(x, group)                    # [size, ..., m, N]
    return torch.cat([g[r][..., :c, :] for r, c in enumerate(counts)
                      if c], dim=-2)


def all_to_all(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """x [size, ...]: chunk j goes to rank j; returns [size, ...] whose
    chunk i came from rank i."""
    assert x.shape[0] == group.size, (x.shape, group.size)
    y = group._out(x)
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=group.pg)
    return group._back(out)


def ring_shift(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Send x to rank+1 and receive rank-1's (the reference's ppermute
    ring, `block_pipeline.py:93-95`); equal shapes on every rank."""
    if group.size == 1:
        return x
    y = group._out(x)
    buf = torch.empty_like(y)
    nxt = (group.rank + 1) % group.size
    prv = (group.rank - 1) % group.size
    ops = [dist.P2POp(dist.isend, y, nxt, group=group.pg),
           dist.P2POp(dist.irecv, buf, prv, group=group.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return group._back(buf)
