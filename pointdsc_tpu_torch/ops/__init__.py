"""Plain PyTorch ops of the eval forward (counterparts of
``pointdsc_tpu/ops``)."""
