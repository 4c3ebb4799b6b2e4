"""fhe_spear_tpu_torch: the PyTorch/CUDA port of fhe_spear_tpu for one
NVIDIA H100.

The JAX package `fhe_spear_tpu` stays beside this one as the reference;
every module here keeps its counterpart's file layout and names, so a
reader can find each module's twin.  Rules of the port:

  * No imports from the reference.  This package imports torch, numpy and
    the standard library only -- never `jax`, and nothing under
    `fhe_spear_tpu`, not even its pure-Python or numpy modules (it keeps
    its own copies of those).  Only the tests import both packages.
  * The card by default.  Entry points run on `device="cuda"` unless the
    caller passes `device="cpu"`, as the tests do.  No path falls back to
    the CPU when CUDA is missing: the card path raises instead.
  * Explicit state.  The device is an argument, and random generators are
    explicit (`numpy.random.RandomState` for host key material, replayed
    in the reference's draw order; `torch.Generator` on the device).
  * Residues are int64 in the torch glue.  Torch on the CPU has no uint32
    `+`, `>=` or `>>`, so canonical residues are held as int64 in [0, p)
    with p < 2^31.  Kernels see 32-bit words internally; each wrapper
    states and checks the dtype it takes.
  * Every TPU kernel on a ported path is a hand-written Hopper kernel
    (`csrc/`), with its plain torch version beside it: a CUDA tensor
    launches the kernel, a CPU tensor runs the plain version.

Ported so far: client-aided RWKV-7 generation on the classic transport
(`models.client_aided.run_generation`, `python -m fhe_spear_tpu_torch
generate`) and on the device-resident client (`models.device_client`, S
streams a call in `generate_tokens_streams`); encrypted
retrieval (`ops.retrieval`, `apps.demo`, `python -m fhe_spear_tpu_torch
retrieval`) and encrypted RAG (`apps.rag`); the fully-encrypted FFN chain
with the dnum-grouped hybrid keyswitch (`models.fully_encrypted`,
`python -m fhe_spear_tpu_torch fullenc`); CKKS bootstrapping
(`ckks.bootstrap`, `ckks.dft`, `ops.polyeval`) and the chain refreshed by
it; FHE-native access control (`apps.access_control`, `apps.noise_study`,
the `access-control` and `noise-study` subcommands); the fhesim accuracy
predictor and its calibration on the port's column engine (`fhesim`,
`python -m fhe_spear_tpu_torch fhesim`); dataset preparation
(`apps.data_prep`); the naive per-column ablation
(`models.naive_inference`); key, ciphertext and generation-state
checkpoints in the reference's on-disk format (`utils.serialization`);
spans and torch.profiler traces (`utils.profiling`); the bench entries
`python -m fhe_spear_tpu_torch.bench_retrieval` / `.bench_fully_enc` /
`.bench_bootstrap` / `.bench_rag` (decode is timed by the cells of
`benchmark/`); and both NTT backends: the bit-reversed Stockham transform
(CUDA kernels in `csrc/ntt.cu`, wrapped by `core/ntt_cuda.py`) and the
natural-order four-step transform of `ntt_backend="mxu"`
(`parallel/ntt_fourstep.py`, CUDA kernels in `csrc/fourstep.cu`, wrapped
by `core/fourstep_cuda.py`); the multi-device modules over
`torch.distributed` (`parallel`).
"""
