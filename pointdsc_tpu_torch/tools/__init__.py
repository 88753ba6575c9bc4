"""The registration demo and scripts that measure the port on a CUDA card.
Like the rest of the package they import torch and numpy only, never JAX."""
