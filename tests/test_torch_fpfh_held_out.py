"""The port's FPFH against the JAX package's on the held-out pairs of
``tools/train_fcgf.py::evaluate``: its six default pairs
(``np.random.default_rng(seed + 777)``, seed 0), drawn by the port's
``make_pair`` (equal to JAX's draws, ``test_torch_descriptor_cli.py``). The
FPFH inlier ratio from the port's FPFH equals the one from JAX's FPFH on the
same views within 1e-3 (one keypoint of ~1400), so the FPFH column of the
evaluation is the same in both packages. Pair 0 is held in
``test_torch_train_fcgf_cli.py::test_held_out_fpfh_matches_jax``."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pointdsc_tpu.descriptors.fpfh import extract_fpfh as j_extract_fpfh  # noqa: E402
from pointdsc_tpu_torch.descriptors.fpfh import extract_fpfh  # noqa: E402
from pointdsc_tpu_torch.tools import train_fcgf  # noqa: E402


@pytest.fixture(scope="module")
def held_out_views():
    """Views and pose of each held-out pair (the draws do not depend on the
    grid)."""
    rng = np.random.default_rng(777)
    return [train_fcgf.make_pair(rng, 0.05, 32)[-1] for _ in range(6)]


def fpfh_ratio(extract, v0, v1, pose):
    kp0, fp0 = (np.asarray(x) for x in extract(v0))
    kp1, fp1 = (np.asarray(x) for x in extract(v1))
    return train_fcgf.inlier_ratio(kp0, np.nan_to_num(fp0), kp1, np.nan_to_num(fp1), pose)


@pytest.mark.parametrize("pair", range(1, 6))
def test_fpfh_ratio_matches_jax(held_out_views, pair):
    ref = fpfh_ratio(lambda v: j_extract_fpfh(v, voxel_size=0.05), *held_out_views[pair])
    port = fpfh_ratio(lambda v: extract_fpfh(v, voxel_size=0.05, device="cpu"),
                      *held_out_views[pair])
    assert abs(port - ref) <= 1e-3, (port, ref)
