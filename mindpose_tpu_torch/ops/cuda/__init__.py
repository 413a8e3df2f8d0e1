"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions."""
from .decode import argmax_shift_decode, argmax_shift_decode_plain  # noqa: F401
