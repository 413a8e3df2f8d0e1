"""``utils/checkpoint.load_pretrained_backbone`` against the JAX package's, leaf for leaf.

The JAX package merges a backbone from a flax msgpack file into a net's
variables where shapes match, resizing a ViT position grid of another size
with ``jax.image.resize(..., "bilinear")``. The port merges the same file
into a port net. Each case starts both from the same variables (the port's
carried across by the converter), loads the same file, and holds the port's
state_dict to the JAX result converted: every tensor bit for bit, a
resized position grid within 1e-6; and the count of loaded tensors to the
one JAX logs. Files: a tiny ViT's with a ``backbone`` scope under
``params``, with a bare ``params`` root, and with no ``params`` key at all;
its position grid at 14x14 (MAE's 224x224: both axes shrink onto 8x6), 6x4
(both grow) and 4x12 (one grows, one shrinks), and with one leaf of
another shape, which stays as it was; the reduced HRNet and ResNet
backbones (parameters and BatchNorm statistics); a port checkpoint of the
same ViT (``torch.save``), bare and inside a net's. Then ``file://``, a
missing file and a URL.
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.backbones.resnet import ResNet as JaxResNet
from mindpose_tpu.models.backbones.vit import ViT as JaxViT
from mindpose_tpu.models.heads.simple_baseline_head import SimpleBaselineHead as JaxHead
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.utils.checkpoint import load_pretrained_backbone as jax_load_pretrained
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.backbones.resnet import ResNet
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.convert import convert_net_variables, convert_variables, vit_mapping
from mindpose_tpu_torch.models.heads import SimpleBaselineHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.utils.checkpoint import (
    load_pretrained_backbone,
    resize_bilinear_antialiased,
    save_checkpoint,
)
from tests.test_torch_hrnet import CFG as HRNET_CFG
from tests.test_torch_vit import TINY, fill_variables

GRID_ATOL = 1e-6
PATCH = 16
TARGET_GRID = (8, 6)
FILTERS = (16, 16)


def _jax_vit():
    return JaxViT(**TINY)


def _port_vit(grid=TARGET_GRID):
    return ViT(image_size=(grid[1] * PATCH, grid[0] * PATCH), **TINY)


def _jax_pair(backbone, in_channels, hw):
    """(JAX variables of Net(backbone, head), the port net holding them)."""
    net = JaxNet(backbone=backbone, head=JaxHead(num_deconv_layers=2, num_deconv_filters=FILTERS,
                                                 num_deconv_kernels=(4, 4),
                                                 in_channels=in_channels))
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)),
                                             train=False))
    return fill_variables(shapes, np.random.RandomState(10))


def _port_net(backbone, in_channels, variables):
    net = Net(backbone, SimpleBaselineHead(num_deconv_layers=2, num_deconv_filters=FILTERS,
                                           num_deconv_kernels=(4, 4), in_channels=in_channels))
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    return net


def _vit_source(grid, seed=11):
    """A tiny ViT's variables at another token grid."""
    shapes = jax.eval_shape(lambda: _jax_vit().init(
        jax.random.PRNGKey(0), jnp.zeros((1, grid[0] * PATCH, grid[1] * PATCH, 3)), train=False))
    return fill_variables(shapes, np.random.RandomState(seed))


def _write(path, tree):
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(jax.tree.map(np.asarray, tree)))
    return str(path)


def _jax_count(caplog):
    for rec in caplog.records:
        if rec.getMessage().startswith("Loaded "):
            return int(rec.getMessage().split()[1])
    return 0


def _check(net, jax_vars, path, caplog, resized=()):
    """Load ``path`` into both; the port's state_dict against the JAX result."""
    before = {k: v.clone() for k, v in net.state_dict().items()}
    caplog.clear()
    with caplog.at_level(logging.INFO):
        want_vars = jax_load_pretrained(path, jax_vars)
    want_count = _jax_count(caplog)
    count = load_pretrained_backbone(path, net)
    want = convert_net_variables(jax.device_get(want_vars), net)
    got = net.state_dict()
    for name, value in got.items():
        if name.endswith("num_batches_tracked"):
            assert torch.equal(value, before[name]), name
        elif name in resized:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0,
                                       atol=GRID_ATOL, err_msg=name)
        else:
            assert torch.equal(value, want[name]), name
    assert count == want_count > 0
    return count, before


@pytest.fixture(scope="module")
def vit_target():
    hw = (TARGET_GRID[0] * PATCH, TARGET_GRID[1] * PATCH)
    return _jax_pair(_jax_vit(), TINY["hidden_dim"], hw)


@pytest.mark.parametrize("layout", ["backbone_scope", "bare_params", "no_params_key"])
def test_vit_from_flax_file_layouts(vit_target, tmp_path, caplog, layout):
    """A 14x14 source grid (both axes shrink onto 8x6): each layout loads every
    backbone leaf, the grid resized; the head stays."""
    src = _vit_source((14, 14))["params"]
    tree = {"backbone_scope": {"params": {"backbone": src}},
            "bare_params": {"params": src}, "no_params_key": src}[layout]
    net = _port_net(_port_vit(), TINY["hidden_dim"], vit_target)
    count, before = _check(net, vit_target, _write(tmp_path / "vit.msgpack", tree), caplog,
                           resized=("backbone.pos_embed",))
    assert count == len(jax.tree.leaves(src))
    after = net.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("head."))
    assert not torch.equal(after["backbone.blocks.0.attn.qkv.weight"],
                           before["backbone.blocks.0.attn.qkv.weight"])


@pytest.mark.parametrize("grid", [(14, 14), (6, 4), (4, 12)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_position_grid_resize_matches_jax_image_resize(grid):
    """The resize alone against ``jax.image.resize(..., "bilinear")``, which
    antialiases an axis that shrinks; ``F.interpolate`` without antialias
    gives another answer there."""
    src = np.random.RandomState(12).standard_normal((1, *grid, 8)).astype(np.float32)
    shape = (1, *TARGET_GRID, 8)
    want = np.asarray(jax.image.resize(jnp.asarray(src), shape, method="bilinear"))
    got = resize_bilinear_antialiased(src, shape)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=GRID_ATOL)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(src).permute(0, 3, 1, 2), size=TARGET_GRID, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    shrinks = grid[0] > TARGET_GRID[0] or grid[1] > TARGET_GRID[1]
    assert (np.abs(plain - want).max() > 1e-2) == shrinks


@pytest.mark.parametrize("grid", [(6, 4), (4, 12)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_vit_grid_grows_and_mixes(vit_target, tmp_path, caplog, grid):
    net = _port_net(_port_vit(), TINY["hidden_dim"], vit_target)
    _check(net, vit_target, _write(tmp_path / "vit.msgpack", _vit_source(grid)), caplog,
           resized=("backbone.pos_embed",))


def test_mismatched_leaf_is_left_untouched(vit_target, tmp_path, caplog):
    src = _vit_source(TARGET_GRID)
    mlp = src["params"]["block_1"]["MlpBlock_0"]["Dense_0"]
    mlp["kernel"] = mlp["kernel"][:, :100]  # another MLP width
    net = _port_net(_port_vit(), TINY["hidden_dim"], vit_target)
    count, before = _check(net, vit_target, _write(tmp_path / "vit.msgpack", src), caplog)
    assert count == len(jax.tree.leaves(src["params"])) - 1
    after = net.state_dict()
    assert torch.equal(after["backbone.blocks.1.mlp.fc1.weight"],
                       before["backbone.blocks.1.mlp.fc1.weight"])
    assert not torch.equal(after["backbone.blocks.1.mlp.fc1.bias"],
                           before["backbone.blocks.1.mlp.fc1.bias"])


@pytest.mark.parametrize("inside_net", [False, True], ids=["bare", "net"])
def test_port_checkpoint_loads_as_its_flax_twin(vit_target, tmp_path, caplog, inside_net):
    """A port file (``torch.save``) of a 224x224 ViT gives what the JAX
    package's load gives from the same weights as flax msgpack."""
    src = _vit_source((14, 14), seed=13)
    source_net = _port_vit((14, 14))
    source_net.load_state_dict(convert_variables(src, vit_mapping(TINY["depth"])), strict=True)
    if inside_net:
        source_net = Net(source_net, SimpleBaselineHead(num_deconv_layers=1, in_channels=64))
    port_file = str(tmp_path / "vit.ckpt")
    save_checkpoint(port_file, source_net)
    flax_file = _write(tmp_path / "vit.msgpack", src)
    want = _port_net(_port_vit(), TINY["hidden_dim"], vit_target)
    _check(want, vit_target, flax_file, caplog, resized=("backbone.pos_embed",))
    got = _port_net(_port_vit(), TINY["hidden_dim"], vit_target)
    assert load_pretrained_backbone(port_file, got) == len(jax.tree.leaves(src["params"]))
    for name, value in got.state_dict().items():
        assert torch.equal(value, want.state_dict()[name]), name


@pytest.mark.parametrize("arch", ["hrnet", "resnet"])
def test_cnn_backbones_with_batch_norm_statistics(tmp_path, caplog, arch):
    """The reduced HRNet and ResNet: parameters and running statistics from a
    ``tools/convert_ckpt.py``-style file (bare ``params`` and ``batch_stats``)."""
    if arch == "hrnet":
        jax_backbone, port_backbone, width = JaxHRNet(stage_cfg=_freeze_cfg(HRNET_CFG)), \
            HRNet(HRNET_CFG), 8
    else:
        jax_backbone, port_backbone, width = JaxResNet(block_counts=(1, 1, 1, 1)), \
            ResNet((1, 1, 1, 1)), 2048
    target = _jax_pair(jax_backbone, width, (64, 64))
    src = fill_variables(jax.eval_shape(lambda: jax_backbone.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)),
        np.random.RandomState(14))
    net = _port_net(port_backbone, width, target)
    count, before = _check(net, target, _write(tmp_path / f"{arch}.msgpack", src), caplog)
    assert count == len(jax.tree.leaves(src))
    after = net.state_dict()
    name = "backbone.bn1.running_var"
    assert not torch.equal(after[name], before[name])


def test_paths_urls_and_missing_files(vit_target, tmp_path, caplog):
    path = _write(tmp_path / "vit.msgpack", _vit_source(TARGET_GRID))
    net = _port_net(_port_vit(), TINY["hidden_dim"], vit_target)
    _check(net, vit_target, "file://" + path, caplog)
    with pytest.raises(FileNotFoundError):
        load_pretrained_backbone(str(tmp_path / "absent.msgpack"), net)
    with pytest.raises(NotImplementedError, match="ROADMAP.*URL download"):
        load_pretrained_backbone("https://example.invalid/vit_b.msgpack", net)
    empty = _write(tmp_path / "empty.msgpack", {"params": {"other": np.zeros(3, np.float32)}})
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert load_pretrained_backbone(empty, net) == 0
    assert "No pretrained backbone tensors matched" in caplog.text
    assert os.path.isfile(path)
