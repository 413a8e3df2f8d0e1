"""Version of mindpose_tpu_torch (the JAX package's, ``mindpose_tpu/version.py``)."""
__version__ = "0.1.0"
