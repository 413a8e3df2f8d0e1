"""The port's ViT backbone and ViTPose net against the JAX package's, on the same weights.

A tiny ViT (hidden 64, depth 2, 4 heads, 16x16 patches) on 128x96 crops (an
8x6 token grid), its flax variables drawn from a numpy seed and carried into
the port by the port's converter:

- float64 on both sides within 1e-10 (measured: 3e-15), float32 within 2e-5
  of each other (measured: 1.7e-6 on outputs up to 4.1); the JAX side's
  hard-coded float32 LayerNorms read as float64 for the float64 run
  (``Float64Numpy``);
- at O2 loosely: JAX keeps the residual stream and the softmax in bf16
  (``dtype=bfloat16``), torch autocast keeps both in float32, so the two
  differ by bf16 rounding (measured: 0.029 on outputs up to 4.1). The port
  at O2 lies within 0.02 of the largest output of JAX's at O2, and no
  farther from the float64 forward than twice JAX's O2 forward is;
- negative controls: the exact GELU, or LayerNorm's epsilon at torch's
  1e-5, put the port's float32 forward beyond the 2e-5 bound (measured:
  5.0e-4 and 6.6e-4); the crops are small (sd 0.05), so the first
  LayerNorm's input variance is small enough for its epsilon to show;
- the converter against the JAX package's ``export_vit_state`` (timm
  names) and its inverse, ``export_variables``;
- ``Net(vit_s, simple_baseline_head)`` as the ViTPose recipes build it
  against JAX's ``create_network("vit_s", ...)`` on 64x48 crops;
- the parameter counts of vit_s/b/l/h with the recipes' head against
  JAX's, from ``jax.eval_shape`` of ``init`` at 256x192.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

import mindpose_tpu.models.backbones.vit as jax_vit_module
from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.models.backbones.convert import export_vit_state
from mindpose_tpu.models.backbones.vit import ViT as JaxViT
from mindpose_tpu_torch.models import create_network, create_network_from_config
from mindpose_tpu_torch.models.backbones import vit as port_vit_module
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.convert import (
    convert_net_variables,
    convert_variables,
    export_variables,
    net_mapping,
    num_heads,
    vit_mapping,
)
from mindpose_tpu_torch.tools import train as port_train
from tests.test_torch_bottomup_loss import Float64Numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(glob.glob(os.path.join(ROOT, "configs", "vitpose", "*.yaml")))
TINY = {"hidden_dim": 64, "depth": 2, "num_heads": 4}
IMAGE_HW = (128, 96)
F64_ATOL = 1e-10
F32_ATOL = 2e-5
O2_RTOL_OF_MAX = 0.02
O2_FACTOR = 2.0
HEAD = {"num_deconv_layers": 2, "num_deconv_filters": [256, 256], "num_deconv_kernels": [4, 4]}
# published parameter counts (mindpose_tpu/models/backbones/vit.py docstrings), in millions
BACKBONE_MILLIONS = {"vit_s": 22, "vit_b": 86, "vit_l": 304, "vit_h": 632}


def fill_variables(shapes, rng):
    """Flax variables of the given shapes from a numpy stream: kernels with
    variance 1 / fan_in, LayerNorm scales in [0.5, 1.5], biases 0.1 sd, the
    position grid 0.02 sd (its init), BatchNorm statistics non-trivial."""

    def fill(path, s):
        names = [p.key for p in path]
        leaf = names[-1]
        if leaf == "kernel":
            # query/key/value [D, H, hd] and Dense/conv kernels: fan-in is all
            # but the last axis, save the attention's heads; out [H, hd, D]
            fan_in = s.shape[0] if names[-2] in ("query", "key", "value") else np.prod(
                s.shape[:-1])
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf == "pos_embedding":
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, unfreeze(shapes))


def tiny_jax_vit(dtype=jnp.float32) -> JaxViT:
    return JaxViT(dtype=dtype, **TINY)


def tiny_port_vit() -> ViT:
    return ViT(image_size=IMAGE_HW[::-1], **TINY)


@pytest.fixture(scope="module")
def tiny():
    net = tiny_jax_vit()
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, *IMAGE_HW, 3)), train=False))
    rng = np.random.RandomState(0)
    variables = fill_variables(shapes, rng)
    x = (0.05 * rng.standard_normal((2, *IMAGE_HW, 3))).astype(np.float32)
    port = tiny_port_vit().eval()
    port.load_state_dict(convert_variables(variables, vit_mapping(TINY["depth"])), strict=True)
    want = np.asarray(jax.jit(lambda v, x: net.apply(v, x, train=False))(variables, x))
    return variables, x, port, want


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _float64_want(variables, x, monkeypatch):
    monkeypatch.setattr(jax_vit_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        net = tiny_jax_vit(jnp.float64)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        out = np.asarray(jax.jit(lambda v, x: net.apply(v, x, train=False))(
            v64, x.astype(np.float64)))
    monkeypatch.undo()
    assert out.dtype == np.float64
    return out


def test_tiny_vit_matches_jax_in_float64_and_float32(tiny, monkeypatch):
    variables, x, port, want32 = tiny
    want64 = _float64_want(variables, x, monkeypatch)
    net64 = tiny_port_vit().double().eval()
    net64.load_state_dict(port.state_dict())
    with torch.no_grad():
        got64 = net64(_nchw(x).double()).permute(0, 2, 3, 1).numpy()
        got32 = _nhwc(port(_nchw(x)))
    assert got64.shape == want64.shape == (2, 8, 6, TINY["hidden_dim"])
    assert np.abs(want64).max() > 1.0
    np.testing.assert_allclose(got64, want64, rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(got32, want32, rtol=0, atol=F32_ATOL)


def test_tiny_vit_at_o2_is_as_close_to_float64_as_jax_at_o2(tiny, monkeypatch):
    variables, x, port, _ = tiny
    want64 = _float64_want(variables, x, monkeypatch)
    jax_bf16 = tiny_jax_vit(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, x: jax_bf16.apply(v, x, train=False))(variables, x),
                      np.float32)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = _nhwc(port(_nchw(x)))
    assert np.abs(got - want).max() <= O2_RTOL_OF_MAX * np.abs(want).max()
    jax_err, port_err = np.abs(want - want64).max(), np.abs(got - want64).max()
    assert 0 < port_err <= O2_FACTOR * jax_err


class _ExactGelu:
    """``torch.nn.functional`` with ``gelu`` the exact (erf) one, whatever asked."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def gelu(x, approximate="none"):
        return torch.nn.functional.gelu(x)


@pytest.mark.parametrize("change", ["exact_gelu", "torch_layer_norm_eps"])
def test_negative_controls_break_the_float32_bound(tiny, monkeypatch, change):
    _, x, port, want = tiny
    net = tiny_port_vit().eval()
    net.load_state_dict(port.state_dict())
    if change == "exact_gelu":
        monkeypatch.setattr(port_vit_module, "F", _ExactGelu())
    else:
        for m in net.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.eps = 1e-5
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert np.abs(got - want).max() > 10 * F32_ATOL


def test_converter_agrees_with_the_jax_export_and_inverts(tiny):
    """``convert_variables`` gives the timm-named tensors the JAX package's
    ``export_vit_state`` gives, bit for bit; ``export_variables`` gives back
    the flax tree."""
    variables, _, port, _ = tiny
    # export_vit_state reads its widths from the arch; the tiny net is its own
    from mindpose_tpu.models.backbones import convert as jax_convert
    jax_convert.VIT_ARCHS["vit_tiny_test"] = dict(hidden=TINY["hidden_dim"],
                                                   heads=TINY["num_heads"], depth=TINY["depth"])
    try:
        exported = export_vit_state("vit_tiny_test", variables)
    finally:
        del jax_convert.VIT_ARCHS["vit_tiny_test"]
    sd = port.state_dict()
    assert set(exported) == set(sd)
    for name, value in exported.items():
        want = torch.from_numpy(np.asarray(value))
        assert torch.equal(sd[name].reshape(want.shape), want), name
    back = export_variables(sd, vit_mapping(TINY["depth"]), num_heads(port))
    flat_want = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_got) == len(flat_want)
    for path, value in flat_want:
        np.testing.assert_array_equal(flat_got[path], value, err_msg=str(path))


def test_vitpose_net_matches_jax_create_network():
    """vit_s + the recipes' head at full width, on two 64x48 crops (4x3 tokens)."""
    jax_net = jax_create_network("vit_s", "simple_baseline_head", head_args=HEAD)
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 64, 48, 3)), train=False))
    rng = np.random.RandomState(1)
    variables = fill_variables(shapes, rng)
    x = (0.5 * rng.standard_normal((2, 64, 48, 3))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jax_net.apply(v, x, train=False))(variables, x))
    net = create_network("vit_s", "simple_baseline_head", backbone_args={"image_size": [48, 64]},
                         head_args=HEAD).eval()
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == want.shape == (2, 16, 12, 17) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL * np.abs(want).max())


@pytest.mark.parametrize("recipe", RECIPES, ids=os.path.basename)
def test_recipe_parameter_counts_equal_jax(recipe):
    """Each recipe's net as parsed: the port's parameters, per tensor, are the
    flax params' (``jax.eval_shape`` of ``init`` at the recipe's 256x192)."""
    args = port_train.parse_train_args(["--config", recipe])
    w, h = args.dataset_setting["image_size"]
    jax_net = jax_create_network(args.backbone_name, args.head_name,
                                 num_joints=args.num_joints, head_args=args.head_setting)
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
                                                 train=False))
    with torch.device("meta"):
        net = create_network_from_config(args)
    counts = {}
    for name, p in net.named_parameters():
        counts[name.split(".")[0]] = counts.get(name.split(".")[0], 0) + p.numel()
    for part in ("backbone", "head"):
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"][part]))
        assert counts[part] == want, part
    assert round(counts["backbone"] / 1e6) in range(BACKBONE_MILLIONS[args.backbone_name] - 1,
                                                   BACKBONE_MILLIONS[args.backbone_name] + 2)
    # every port tensor is named by the mapping (on the meta device: shapes only)
    names = {n for kind, name, _ in net_mapping(net) for n in net.state_dict()
             if n == name or n.startswith(name + ".")}
    assert names == set(net.state_dict())


def test_vit_settings_are_checked():
    with torch.device("meta"):
        assert create_network("vit_b", "simple_baseline_head", backbone_pretrained=True,
                              backbone_ckpt_url="unused", head_args=HEAD).backbone.grid == (16, 12)
    with pytest.raises(TypeError, match="unknown ViT settings"):
        create_network("vit_s", "simple_baseline_head", backbone_args={"remat": True})
    with pytest.raises(ValueError, match="multiple of the patch"):
        ViT(image_size=(100, 128), **TINY)
    net = tiny_port_vit()
    with pytest.raises(ValueError, match="token grid"):
        net(torch.zeros(1, 3, 64, 48))
