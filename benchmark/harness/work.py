"""The least work of PointDSC's eval forward, counted from shapes, and the least time it takes at the card's published peaks.

"Least" means the work the function needs, whatever implements it: every
input byte read once and every output written once, each product counted
once (no recomputation), a symmetric quantity over unordered pairs. Each
class of operations is taken at the peak of the precision the
configuration states for it. Work that depends on the data, or that no
kernel can avoid only at a cost below these terms (the softmax's
exponentials, the seed NMS's compares, the post-refinement), is left out:
the counts are lower bounds, so a share of a peak computed from them
cannot pass 100% unless a time leaves out part of the work.

Frozen copies of the program's counters (``chip_smoke.py::bound_ms``,
``kernels/sc_attention.py::compat_cache_work``), restated as least work, so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

# f32 operations of one compatibility entry from the two points' coordinates:
# two 3-vector differences and squared norms (16), two square roots and
# their difference (3), square, scale, 1 - x and clamp (4)
OPS_PER_COMPAT_ENTRY = 23


def _seconds(ops_by_precision: dict) -> float:
    return sum(ops / PEAK_FLOPS[p] for p, ops in ops_by_precision.items())


def layer_ops(n: int, c: int) -> tuple[float, float]:
    """One encoder layer on n points at width c: (Dense operations, the
    attention's two n^2 c products). PointCN, Q, K, V: four c x c
    products; the message MLP c -> c/2 -> c/2 -> c."""
    dense = 2.0 * n * (4 * c * c + c * (c // 2) + (c // 2) * (c // 2) + (c // 2) * c)
    return dense, 4.0 * n * n * c


def encoder_seconds(n: int, c: int, layers: int, precision: dict) -> float:
    """The least time of the eval encoder's ``layers`` layers on n valid
    points: Dense products at ``precision["dense"]``, the attention's
    products at ``precision["attention"]``."""
    dense, attn = layer_ops(n, c)
    return layers * _seconds({precision["dense"]: dense, precision["attention"]: attn})


def attention_seconds(n: int, c: int, layers: int, precision: dict) -> float:
    """The least time of the eval encoder's ``layers`` attentions on n valid
    points: the two n^2 c products at ``precision["attention"]``."""
    return layers * _seconds({precision["attention"]: layer_ops(n, c)[1]})


def eval_forward_seconds(n: int, cfg: dict, precision: dict) -> float:
    """The least time of one eval forward on n valid correspondences: the
    compatibility entries (each unordered pair once), the encoder, the
    input lift and confidence head, the seed k-NN's feature products and
    each seed's k x k feature products and power iteration, and the
    hypotheses' inlier counts."""
    c, layers, k = cfg["num_channels"], cfg["num_layers"], cfg["k"]
    s = max(1, int(n * cfg["ratio"]))
    f32 = (n * (n + 1) / 2.0 * OPS_PER_COMPAT_ENTRY
           + 2.0 * n * (cfg["in_dim"] * c + c * 32 + 32 * 32 + 32)
           + 2.0 * s * n * c
           + s * (k * (k - 1) / 2.0 * 2 * c + cfg["num_iterations"] * 2.0 * k * k)
           + s * n * 20.0)
    return _seconds({precision["dense"]: f32}) + encoder_seconds(n, c, layers, precision)
