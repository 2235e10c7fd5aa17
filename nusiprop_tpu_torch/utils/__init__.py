"""Subpackage of the PyTorch/CUDA port (see nusiprop_tpu_torch)."""
