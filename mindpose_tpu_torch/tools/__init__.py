"""Entry points of the port, run as ``python3 -m mindpose_tpu_torch.tools.<name>``."""
