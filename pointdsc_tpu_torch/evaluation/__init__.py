"""The benchmark CLIs (counterparts of the JAX package's ``evaluation/*.py``):
``python -m pointdsc_tpu_torch.evaluation.test_3DMatch``, ``.test_3DLoMatch``
and ``.test_KITTI``."""
