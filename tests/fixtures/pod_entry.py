"""The port's train entry with the fixtures' reduced HRNet registered.

tests/test_torch_tools.py's two-host launch sets this module as
``mindpose_tpu_torch.tools.launch_pod.TRAIN_ENTRY``, so that torchrun's
ranks train the fixture's net (``python -m tests.fixtures.pod_entry`` takes the
train entry's command line). It imports torch and the port only, never JAX.
"""
from mindpose_tpu_torch.tools import train
from tests.fixtures.eval_checks import register_port_backbone

if __name__ == "__main__":
    register_port_backbone()
    train.main()
