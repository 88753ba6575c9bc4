"""Determinism helper (counterpart of ``pointdsc_tpu/utils/seed.py``): pins
the host-side randomness of the data pipeline and PyTorch's global
generators. Model weights come from an explicit ``torch.Generator``."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 51) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
