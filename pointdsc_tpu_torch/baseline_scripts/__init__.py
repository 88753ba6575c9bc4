"""The classical-baseline CLIs: ``baseline_3DMatch`` and ``baseline_KITTI``."""
