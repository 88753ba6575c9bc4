"""Hand-written CUDA kernels of the eval forward and of training, and their wrappers.

Each wrapper keeps a plain integer ``launches`` that it raises by one where
it launches its kernel, and nowhere else; ``reset_launches`` and
``launch_counts`` read them all. CUDA code is built and loaded only inside a
launch, never at import (kernels/_build.py).
"""

from pointdsc_tpu_torch.kernels.conf_mlp import confidence_head
from pointdsc_tpu_torch.kernels.encoder_layer import (
    attn_mlp_residual,
    fused_encoder_layer,
    pcn_qkv,
)
from pointdsc_tpu_torch.kernels.nms import nms_local_max
from pointdsc_tpu_torch.kernels.refine import fused_post_refinement
from pointdsc_tpu_torch.kernels.sc_attention import (
    build_compat_cache_int8,
    fused_sc_attention,
    fused_sc_attention_cached,
    sc_attention_backward_dkv,
    sc_attention_backward_dq,
    sc_attention_cached_offset,
    sc_attention_forward,
)
from pointdsc_tpu_torch.kernels.scoring import seed_inlier_counts
from pointdsc_tpu_torch.kernels.seed_knn import seed_knn_exact
from pointdsc_tpu_torch.kernels.sm_loss import sm_loss_grads, sm_loss_sums

WRAPPERS = {
    "compat_cache_int8": build_compat_cache_int8,
    "sc_attention_cached": fused_sc_attention_cached,
    "sc_attention_cached_offset": sc_attention_cached_offset,
    "fused_encoder_layer": fused_encoder_layer,
    "pcn_qkv": pcn_qkv,
    "attn_mlp_residual": attn_mlp_residual,
    "confidence_head": confidence_head,
    "nms_local_max": nms_local_max,
    "seed_knn_exact": seed_knn_exact,
    "seed_inlier_counts": seed_inlier_counts,
    "fused_post_refinement": fused_post_refinement,
    "fused_sc_attention": fused_sc_attention,
    "sc_attention_forward": sc_attention_forward,
    "sc_attention_backward_dq": sc_attention_backward_dq,
    "sc_attention_backward_dkv": sc_attention_backward_dkv,
    "sm_loss_sums": sm_loss_sums,
    "sm_loss_grads": sm_loss_grads,
}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
