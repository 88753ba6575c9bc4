"""Classical registration baselines (SM, RANSAC, GC-RANSAC, LS, PMC)."""

from pointdsc_tpu_torch.baselines.classical import (
    gc_ransac_registration,
    gc_ransac_registration_pygc,
    least_squares_fit,
    pmc_registration,
    ransac_registration,
    spectral_matching,
)
