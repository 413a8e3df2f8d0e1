"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions."""
from .conv_chain import conv_chain_plain, fused_conv_chain  # noqa: F401
from .decode import (  # noqa: F401
    argmax_shift_decode,
    argmax_shift_decode_plain,
    decode_heatmap,
    decode_heatmap_plain,
)
