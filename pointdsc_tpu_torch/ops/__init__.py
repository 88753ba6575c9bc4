"""Plain PyTorch ops of the eval forward and of registration (ICP,
descriptor matching); counterparts of ``pointdsc_tpu/ops``."""
