"""Transforms and (later) multi-device modules of the port (counterpart of
`fhe_spear_tpu/parallel`).  So far: the four-step NTT backend."""
