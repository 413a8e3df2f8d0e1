"""Port's higher_hrnet_head (and HRNet + the head) against the JAX package's, on the same weights.

The JAX variables, with non-trivial BatchNorm parameters and running
statistics, are carried into the port by the port's own converter
(``models/convert.py``), and both run on the same input in float32 on the
CPU. The two libraries sum each convolution in other orders, so every
output agrees within ``RTOL_OF_MAX`` of its largest |value| (measured:
below 2e-6), not bitwise.

Both forms of the JAX head are held: ``s2d_refine`` on (its default, and
the HigherHRNet-W32 recipe's), which runs the refinement stage in 2x2
space-to-depth form and consumes the transposed conv's kernel through
``scatter_deconv4x4_s2``, and off (the plain ``ConvTranspose``). The port
runs the plain stage for both. Without the kernel's spatial flip the
outputs are far off. At full width the recipe's net (HRNet-W32 with the
recipe's ``branch0_s2d``) has the same variables in both packages.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.core import unfreeze

from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.heads.higher_hrnet_head import HigherHRNetHead as JaxHead
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.models import create_network_from_config
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.convert import (
    convert_net_variables,
    convert_variables,
    head_mapping,
    net_mapping,
)
from mindpose_tpu_torch.models.heads import HigherHRNetHead
from mindpose_tpu_torch.models.networks import Net
from tests.test_torch_hrnet import CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "higher_hrnet", "higher_hrnet_w32_tpu.yaml")
FILTERS = (16,)
RTOL_OF_MAX = 2e-5
# in train mode the BatchNorm normalizes over the batch's few values per
# channel, which magnifies those differences
TRAIN_RTOL_OF_MAX = 1e-4


def _randomize(variables, rng):
    """Non-trivial BN affine parameters and running statistics; final convs
    drawn so that the outputs are O(1), as a trained head's are."""
    variables = unfreeze(jax.device_get(variables))

    def walk(tree, path=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            elif path[-1].startswith(("BatchNorm", "stem_bn")):
                if key in ("scale", "var"):
                    tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
                else:  # bias, mean
                    tree[key] = (0.2 * rng.standard_normal(value.shape)).astype(np.float32)
            elif path[-1].startswith("final_"):
                scale = 0.05 if key == "kernel" else 0.1
                tree[key] = (scale * rng.standard_normal(value.shape)).astype(np.float32)

    walk(variables)
    return variables


def _close(got, want, rtol_of_max=RTOL_OF_MAX):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol_of_max * float(np.abs(want).max()))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _head_pair(s2d_refine: bool, in_channels: int = 8):
    jax_head = JaxHead(in_channels=in_channels, num_deconv_filters=FILTERS,
                       s2d_refine=s2d_refine)
    port = HigherHRNetHead(in_channels=in_channels, num_deconv_filters=FILTERS,
                           s2d_refine=s2d_refine)
    return jax_head, port


@pytest.mark.parametrize("s2d_refine", [True, False])
def test_head_matches_flax(s2d_refine):
    """The head on [2, 5, 3, 8] features (unequal sides, so a shifted or
    transposed output shows), at inference and in train mode."""
    rng = np.random.RandomState(3)
    jax_head, head = _head_pair(s2d_refine)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    variables = _randomize(jax.jit(lambda k, x: jax_head.init(k, x, train=False))(
        jax.random.PRNGKey(1), x), rng)
    head.load_state_dict(convert_variables(variables, head_mapping(head)), strict=True)
    want = jax.jit(lambda v, x: jax_head.apply(v, x, train=False))(variables, x)
    head.eval()
    with torch.no_grad():
        got = head(_nchw(x))
    assert [tuple(w.shape) for w in want] == [(2, 5, 3, 34), (2, 10, 6, 17)]
    assert len(got) == 2
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0.1
        _close(_nhwc(g), np.asarray(w))

    want, _ = jax.jit(lambda v, x: jax_head.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    head.train()
    with torch.no_grad():
        got = head(_nchw(x))
    for g, w in zip(got, want):
        _close(_nhwc(g), np.asarray(w), TRAIN_RTOL_OF_MAX)


@pytest.mark.parametrize("s2d_refine", [True, False])
def test_head_needs_the_kernel_flip(s2d_refine):
    """The same weights carried across without the transposed conv's spatial
    flip give a level-1 output far off."""
    rng = np.random.RandomState(4)
    jax_head, head = _head_pair(s2d_refine)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    variables = _randomize(jax.jit(lambda k, x: jax_head.init(k, x, train=False))(
        jax.random.PRNGKey(2), x), rng)
    want = np.asarray(jax.jit(lambda v, x: jax_head.apply(v, x, train=False))(variables, x)[1])
    sd = convert_variables(variables, head_mapping(head))
    sd["deconv_layers.0.0.weight"] = sd["deconv_layers.0.0.weight"].flip(2, 3)  # undone
    head.load_state_dict(sd, strict=True)
    head.eval()
    with torch.no_grad():
        got = _nhwc(head(_nchw(x))[1])
    assert np.abs(got - want).max() > 100 * RTOL_OF_MAX * np.abs(want).max()


@pytest.mark.parametrize("s2d_refine", [True, False])
def test_reduced_net_matches_flax(s2d_refine):
    """A reduced HRNet (tests/test_torch_hrnet.py's CFG) + the head on 64x64 images."""
    rng = np.random.RandomState(5)
    jax_net = JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(CFG)),
                     head=JaxHead(in_channels=8, num_deconv_filters=FILTERS,
                                  s2d_refine=s2d_refine))
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = _randomize(jax.jit(lambda k, x: jax_net.init(k, x, train=False))(
        jax.random.PRNGKey(0), x[:1]), rng)
    port = Net(HRNet(CFG), HigherHRNetHead(in_channels=8, num_deconv_filters=FILTERS))
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
    want = jax.jit(lambda v, x: jax_net.apply(v, x, train=False))(variables, x)
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x))
    assert [tuple(w.shape) for w in want] == [(2, 16, 16, 34), (2, 32, 32, 17)]
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0.1
        _close(_nhwc(g), np.asarray(w))


def _flax_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flax_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("s2d_refine", [True, False])
def test_the_recipe_net_has_the_same_variables_in_both_packages(s2d_refine):
    """higher_hrnet_w32_tpu.yaml's net at full width, from ``jax.eval_shape``
    (no weights computed): the mapping uses each flax leaf once and names
    each port tensor once, shapes matching after the layout change."""
    with open(YAML) as f:
        cfg = yaml.safe_load(f)
    head_setting = dict(cfg["head_setting"], s2d_refine=s2d_refine)
    jax_net = jax_create_network(cfg["backbone_name"], cfg["head_name"],
                                 num_joints=cfg["num_joints"],
                                 backbone_args=cfg["backbone_setting"], head_args=head_setting)
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 512, 512, 3)), train=False))
    flax = {("params",) + k: v for k, v in _flax_shapes(unfreeze(shapes["params"])).items()}
    flax.update({("batch_stats",) + k: v
                 for k, v in _flax_shapes(unfreeze(shapes["batch_stats"])).items()})
    with torch.device("meta"):
        net = create_network_from_config(Config(**dict(cfg, head_setting=head_setting)))
    port = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    used, named = [], {}
    for kind, name, path in net_mapping(net):
        if kind in ("conv", "conv_bias", "deconv"):
            kh, kw, i, o = flax[("params",) + path + ("kernel",)]
            named[f"{name}.weight"] = (i, o, kh, kw) if kind == "deconv" else (o, i, kh, kw)
            used.append(("params",) + path + ("kernel",))
            if kind == "conv_bias":
                named[f"{name}.bias"] = flax[("params",) + path + ("bias",)]
                used.append(("params",) + path + ("bias",))
        else:
            for leaf, group, tname in (("scale", "params", "weight"), ("bias", "params", "bias"),
                                       ("mean", "batch_stats", "running_mean"),
                                       ("var", "batch_stats", "running_var")):
                named[f"{name}.{tname}"] = flax[(group,) + path + (leaf,)]
                used.append((group,) + path + (leaf,))
            named[f"{name}.num_batches_tracked"] = ()
    assert sorted(used) == sorted(flax)
    assert named == port
    head_leaves = [k for k in flax if k[1] == "head"]
    assert len(head_leaves) == 49
    n_params = sum(int(np.prod(s)) for k, s in flax.items() if k[0] == "params")
    assert n_params == sum(p.numel() for p in net.parameters())
