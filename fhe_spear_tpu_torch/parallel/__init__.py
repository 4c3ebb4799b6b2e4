"""Transforms and multi-device modules of the port (counterpart of
`fhe_spear_tpu/parallel`): the four-step NTT backend (and its sharded
form), rank groups and exact collectives over `torch.distributed`, the
giant-sharded BSGS matvec with the server and the fully-encrypted chain
built on it, limb-sharded keyswitching and eval keys, the block pipeline,
and the multi-rank dry run (`python -m fhe_spear_tpu_torch.parallel.dryrun`).
"""
