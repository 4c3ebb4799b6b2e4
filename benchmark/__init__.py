"""The benchmark of the PyTorch and CUDA port (`fhe_spear_tpu_torch`):
encrypted RWKV-7 decoding on one NVIDIA card.  Run a cell with
`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of the repository; see harness.py."""
