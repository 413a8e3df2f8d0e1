from .backbone import Backbone  # noqa: F401
from .hrnet import HRModule, HRNet, hrnet_w32, hrnet_w48, w_cfg  # noqa: F401
from .resnet import BasicBlock, Bottleneck, ResNet, resnet50, resnet101, resnet152  # noqa: F401
