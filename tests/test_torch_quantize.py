"""The port's int8 weight quantization against the JAX package's, leaf for leaf.

``mindpose_tpu_torch/models/quantize.py`` quantizes a ``state_dict`` by the
JAX package's rule (``mindpose_tpu/models/quantize.py``). On the same
weights, carried across by the port's converter, for a reduced HRNet, a
reduced SimpleBaseline (transposed convs: the output axis is dim 1), a tiny
ViTPose net (the fused ``qkv`` with one scale per head-dim index, shared by
the heads; ``proj`` one per row) and the reduced ResNet with the RLE and
the SimCC heads (``Linear`` layers):

- the set of quantized flax leaves is JAX's;
- the int8 values and the scales, carried back to flax's layout by
  ``models/convert.export_variables`` (a scale broadcast over its weight
  first), equal JAX's ``quantize_variables`` bit for bit, and so do the
  dequantized weights;
- ``quantized_bytes`` equals JAX's.

Then the port's ``TopDownPredictor(quantize="int8")`` on the CPU against the
JAX composition of tests/test_torch_predictor.py run through JAX's
``quantized_eval_apply``, within that test's tolerances (1e-3 px where a
joint's peak leads by more than 1e-4, scores within 1e-4); it serves
bit for bit what a float32 predictor serves on the dequantized weights, and
it keeps no float copy of a quantized weight.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.models.backbones.vit import ViT as JaxViT
from mindpose_tpu.models.heads.rle_head import RLERegressionHead as JaxRLEHead
from mindpose_tpu.models.heads.simcc_head import SimCCHead as JaxSimCCHead
from mindpose_tpu.models.heads.simple_baseline_head import SimpleBaselineHead as JaxSBHead
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.models.quantize import dequantize_variables as jax_dequantize
from mindpose_tpu.models.quantize import quantize_variables as jax_quantize
from mindpose_tpu.models.quantize import quantized_bytes as jax_quantized_bytes
from mindpose_tpu_torch.engine import TopDownPredictor
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.convert import (
    convert_net_variables,
    export_variables,
    net_mapping,
    num_heads,
)
from mindpose_tpu_torch.models.heads import RLERegressionHead, SimCCHead, SimpleBaselineHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.models.quantize import (
    QTensor,
    dequantize_variables,
    quantize_variables,
    quantized_bytes,
)
from tests.test_torch_hrnet import build_pair as hrnet_pair
from tests.test_torch_predictor import MEAN, SETTING, STD, _jax_composition, _request, _top2_gap
from tests.test_torch_simcc import FEATURE_SIZE, IMAGE_SIZE, reduced_pair
from tests.test_torch_simple_baseline import _reduced_pair as simple_baseline_pair
from tests.test_torch_vit import TINY, fill_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

VIT_HW = (128, 96)  # (H, W): an 8x6 token grid at patch 16
VIT_HEAD = {"num_deconv_layers": 2, "num_deconv_filters": (16, 16), "num_deconv_kernels": (4, 4)}


def _vit_pair():
    jax_net = JaxNet(backbone=JaxViT(**TINY), head=JaxSBHead(**VIT_HEAD))
    shapes = jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, *VIT_HW, 3)), train=False))
    variables = fill_variables(shapes, np.random.RandomState(5))
    port = Net(ViT(image_size=VIT_HW[::-1], **TINY),
               SimpleBaselineHead(in_channels=TINY["hidden_dim"], **VIT_HEAD))
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
    return jax_net, variables, port


def _pair(name):
    if name == "hrnet":
        return hrnet_pair()[:3]
    if name == "simple_baseline":
        return simple_baseline_pair()
    if name == "vitpose":
        return _vit_pair()
    if name == "rle":
        return reduced_pair(JaxRLEHead(), RLERegressionHead())
    return reduced_pair(JaxSimCCHead(input_size=IMAGE_SIZE),
                        SimCCHead(input_size=IMAGE_SIZE, feature_size=FEATURE_SIZE))


NETS = ["hrnet", "simple_baseline", "vitpose", "rle", "simcc"]


@pytest.fixture(scope="module", params=NETS)
def quantized(request):
    _, variables, port = _pair(request.param)
    state = port.state_dict()
    return request.param, variables, port, state, jax_quantize(variables), \
        quantize_variables(state, port)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale"}:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _flax(state, port):
    """A state_dict in flax's layout, as ``{flax path: numpy array}``."""
    return dict(_leaves(export_variables(state, net_mapping(port), num_heads(port))))


def _flax_kernel_paths(port, keys):
    """The flax kernel leaves that the port's tensors ``keys`` convert from."""
    paths = set()
    for kind, name, path in net_mapping(port):
        if f"{name}.weight" in keys:
            parts = [(p, "kernel") for p in ("query", "key", "value")] if kind == "qkv" \
                else [("kernel",)]
            paths |= {("params",) + path + part for part in parts}
    return paths


def test_the_quantized_leaves_are_jax_s(quantized):
    name, _, port, state, jax_q, port_q = quantized
    want = {p for p, v in _leaves(jax_q) if isinstance(v, dict)}
    got_keys = {k for k, v in port_q.items() if isinstance(v, QTensor)}
    assert want, name
    assert _flax_kernel_paths(port, got_keys) == want
    # everything else is the float state, untouched
    for k, v in port_q.items():
        if not isinstance(v, QTensor):
            assert v is state[k], k
    if name == "vitpose":
        assert {"backbone.blocks.0.attn.qkv.weight", "backbone.blocks.0.attn.proj.weight",
                "head.deconv_layers.0.weight"} <= got_keys
    assert quantized_bytes(port_q) == jax_quantized_bytes(jax_q)


def test_int8_values_and_scales_are_jax_s_bit_for_bit(quantized):
    name, _, port, state, jax_q, port_q = quantized
    qkeys = [k for k, v in port_q.items() if isinstance(v, QTensor)]
    assert all(port_q[k].q.dtype == torch.int8 and port_q[k].scale.dtype == torch.float32
               for k in qkeys)
    q_state, scale_state = dict(state), dict(state)
    for k in qkeys:
        t = port_q[k]
        q_state[k] = t.q.to(torch.float32)
        scale_state[k] = (torch.ones(t.groups) * t.scale).reshape(t.q.shape)
    got_q, got_scale = _flax(q_state, port), _flax(scale_state, port)
    want = dict(_leaves(jax_q))
    for path in _flax_kernel_paths(port, set(qkeys)):
        q, scale = np.asarray(want[path]["q"]), np.asarray(want[path]["scale"])
        assert q.dtype == np.int8
        np.testing.assert_array_equal(got_q[path], q.astype(np.float32), err_msg=str(path))
        # each weight's scale, broadcast over the flax kernel: JAX's, by output channel
        np.testing.assert_array_equal(got_scale[path], np.broadcast_to(scale, q.shape),
                                      err_msg=str(path))
        assert got_scale[path].dtype == scale.dtype == np.float32


def test_dequantized_weights_are_jax_s_bit_for_bit(quantized):
    _, _, port, _, jax_q, port_q = quantized
    got = _flax(dequantize_variables(port_q), port)
    want = dict(_leaves(jax_dequantize(jax_q)))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(value), err_msg=str(path))


def test_an_unknown_mode_is_an_error():
    port = hrnet_pair()[2]
    with pytest.raises(ValueError, match="quantize"):
        TopDownPredictor(port, SETTING, quantize="fp4", device="cpu")


@pytest.fixture(scope="module")
def hrnet():
    return hrnet_pair()


@pytest.mark.parametrize("decoder_setting", [{"shift_coordinate": True}, {"use_udp": True}])
def test_int8_predictor_matches_the_jax_quantized_composition(hrnet, decoder_setting):
    jax_net, variables, port, _ = hrnet
    image, boxes = _request()
    want, heat = _jax_composition(jax_net, variables, image, boxes, decoder_setting,
                                  quantize=True)
    # the int8 predictor moves the net's quantized weights to the meta device
    predictor = TopDownPredictor(copy.deepcopy(port), SETTING, decoder_setting, MEAN, STD,
                                 batch_size=2, quantize="int8", device=torch.device("cpu"))
    got = predictor(image, boxes)
    assert got.shape == (5, 17, 3)
    clear = _top2_gap(heat) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got[..., :2][clear], want[..., :2][clear], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-4, rtol=0)


def test_int8_predictor_serves_the_dequantized_weights_and_holds_no_float_copy():
    _, _, port, _ = hrnet_pair()
    image, boxes = _request()
    predictor = TopDownPredictor(port, SETTING, {"shift_coordinate": True}, MEAN, STD,
                                 batch_size=2, quantize="int8", device="cpu")
    got = predictor(image, boxes)
    quantized = [k for k, v in predictor.qstate.items() if isinstance(v, QTensor)]
    served = predictor.net.state_dict()
    assert quantized and all(served[k].device.type == "meta" for k in quantized)
    assert all(served[k].device.type == "cpu" for k in served if k not in quantized)

    float_net = hrnet_pair()[2]
    float_net.load_state_dict(dequantize_variables(predictor.qstate), strict=True)
    want = TopDownPredictor(float_net, SETTING, {"shift_coordinate": True}, MEAN, STD,
                            batch_size=2, device="cpu")(image, boxes)
    np.testing.assert_array_equal(got, want)
