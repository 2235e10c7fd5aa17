"""Subpackage of the PyTorch/CUDA port (see nusiprop_tpu_torch): the
parameter-grid scans (``scan``) and the storage-sharded E' march
(``eshard``)."""
