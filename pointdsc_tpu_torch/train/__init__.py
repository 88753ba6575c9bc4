"""Training: config, losses, Trainer (counterpart of ``pointdsc_tpu/train``)."""
