"""Port's HRNet + hrnet_head against the JAX package's, on the same weights.

A reduced HRNet (width 8, 1-2 modules per stage, 1-2 blocks per branch, all
four stages, so every transition and fusion shape occurs) is built in JAX,
given non-trivial BN parameters and running statistics, carried into the
port with the port's own converter, and both are run on the same input.
Heatmaps agree to atol 1e-4: both are float32 on the CPU, but the two
libraries sum each convolution in a different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from mindpose_tpu.models.backbones.convert import hrnet_mapping as jax_hrnet_mapping
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.common import resize_nearest as jax_resize_nearest
from mindpose_tpu.models.heads.hrnet_head import HRNetHead as JaxHRNetHead
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu_torch.models import (
    create_backbone,
    create_decoder,
    create_eval_network,
    create_network,
)
from mindpose_tpu_torch.models.backbones.hrnet import HRNet, w_cfg
from mindpose_tpu_torch.models.common import resize_nearest
from mindpose_tpu_torch.models.convert import convert_net_variables, hrnet_mapping
from mindpose_tpu_torch.models.heads import HRNetHead
from mindpose_tpu_torch.models.networks import Net

CFG = {
    "stage1": {"num_modules": 1, "num_branches": 1, "block": "BOTTLENECK",
               "num_blocks": (1,), "num_channels": (8,)},
    "stage2": {"num_modules": 1, "num_branches": 2, "block": "BASIC",
               "num_blocks": (1, 2), "num_channels": (8, 16)},
    "stage3": {"num_modules": 1, "num_branches": 3, "block": "BASIC",
               "num_blocks": (2, 1, 1), "num_channels": (8, 16, 32)},
    # two modules: the first fuses into all four outputs, the last into one
    "stage4": {"num_modules": 2, "num_branches": 4, "block": "BASIC",
               "num_blocks": (1, 1, 2, 1), "num_channels": (8, 16, 32, 64),
               "multiscale_output": False},
}


def _randomize(variables, rng):
    """Non-trivial BN affine params and running stats.

    Running stats that do not fit the activations let them grow block by
    block (to ~1e3 here), so the head is drawn small enough that heatmaps
    come out O(1), like a trained model's.
    """
    variables = unfreeze(jax.device_get(variables))

    def walk(tree, path=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            elif path[-1].startswith("BatchNorm") or path[-1].startswith("stem_bn"):
                if key in ("scale", "var"):
                    tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
                else:  # bias, mean
                    tree[key] = (0.2 * rng.standard_normal(value.shape)).astype(np.float32)
            elif path[-1] == "head" and key == "kernel":
                tree[key] = (5e-4 * rng.standard_normal(value.shape)).astype(np.float32)
            elif path[-1] == "head" and key == "bias":
                tree[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)

    walk(variables)
    return variables


def build_pair():
    """(JAX net, its variables, port net with the same weights, input NHWC)."""
    jax_net = JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(CFG)),
                     head=JaxHRNetHead(in_channels=8, num_joints=17))
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 64, 48, 3)).astype(np.float32)
    init = jax.jit(lambda key, x: jax_net.init(key, x, train=False))  # faster than eager here
    variables = _randomize(init(jax.random.PRNGKey(0), jnp.asarray(x[:1])), rng)
    port = Net(HRNet(CFG), HRNetHead(8, 17))
    port.load_state_dict(convert_net_variables(variables, CFG), strict=True)
    return jax_net, variables, port, x


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_eval_forward_matches_jax(pair):
    jax_net, variables, port, x = pair
    want = np.asarray(jax_net.apply(variables, jnp.asarray(x), train=False))  # NHWC
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert np.abs(want).max() > 0.5  # the comparison is not between near-zero maps
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-4, rtol=0)


def test_train_forward_and_running_stats_match_jax(pair):
    jax_net, variables, port, x = pair
    want, updates = jax_net.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    net = Net(HRNet(CFG), HRNetHead(8, 17))
    net.load_state_dict(port.state_dict())
    net.train()
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).detach().numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), np.asarray(want), atol=1e-4, rtol=0)
    # running stats after one step: flax's EMA with the biased batch variance
    want_sd = convert_net_variables(
        {"params": variables["params"], "batch_stats": jax.device_get(updates["batch_stats"])}, CFG)
    got_sd = net.state_dict()
    for name in want_sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[name].numpy(), want_sd[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("width", [32, 48])
def test_mapping_pairs_the_same_entries_as_the_jax_export(width):
    assert hrnet_mapping(w_cfg(width)) == jax_hrnet_mapping(width)


def test_mapping_names_every_tensor_of_the_port_module():
    names = set()
    for kind, prefix, _ in hrnet_mapping(w_cfg(32)):
        leaves = ("weight",) if kind == "conv" else (
            "weight", "bias", "running_mean", "running_var", "num_batches_tracked")
        names.update(f"{prefix}.{leaf}" for leaf in leaves)
    sd = create_backbone("hrnet_w32").state_dict()
    assert set(sd) == names
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) == 1460
    assert "stage4.2.fuse_layers.0.3.1.running_var" in sd


@pytest.mark.parametrize("hw", [(8, 6), (16, 12), (12, 9), (5, 7)])
def test_resize_nearest_matches_jax(hw):
    x = np.random.RandomState(1).standard_normal((2, 4, 3, 5)).astype(np.float32)  # NHWC
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), *hw))
    got = resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), *hw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_tpu_knobs_are_checked():
    # exact TPU rewrites and the fused-backward BN are plain BN here
    create_network("hrnet_w32", "hrnet_head",
                   backbone_args={"stem_s2d": True, "branch0_s2d": True, "bn_grad_stats": "fused"})
    with pytest.raises(NotImplementedError, match="performance.md"):
        create_backbone("hrnet_w32", bn_grad_stats="frozen")
    with pytest.raises(NotImplementedError, match="performance.md"):
        create_backbone("hrnet_w32", bn_stats_frac=0.25)
    with pytest.raises(NotImplementedError):
        create_backbone("hrnet_w32", remat=True)
    with pytest.raises(TypeError):
        create_backbone("hrnet_w32", no_such_setting=1)


def test_eval_net_runs_eval_mode_and_returns_the_raw_heatmap(pair):
    _, _, port, x = pair
    port.train()
    eval_net = create_eval_network(port, create_decoder("topdown_heatmap"), output_raw=True)
    assert not port.training
    image = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    n = image.shape[0]
    (preds, boxes), heat = eval_net(image, torch.zeros(n, 2), torch.ones(n, 2), torch.ones(n))
    with torch.no_grad():
        np.testing.assert_array_equal(heat.numpy(), port(image).numpy())
    assert preds.shape == (n, 17, 3) and boxes.shape == (n, 6)


@pytest.mark.parametrize("case", ["normal", "large_mean"])
def test_bf16_train_batch_norm_matches_flax(case):
    """Train-mode BN on bf16 input: float32 statistics, bf16 output, as flax.

    ``large_mean`` is x = 10 + 0.1 N(0, 1): statistics taken in bf16 read
    variance 0 there. Tolerances: the output is float32 arithmetic rounded
    to bf16 on both sides, and the two sum in different orders, so an
    element may round to the neighbouring bf16 value (one ulp). The running
    variance E[x^2] - E[x]^2 cancels E[x^2] ~ 100 down to ~0.01, so it agrees
    to a few float32 ulps of E[x^2], not of the variance.
    """
    from flax import linen as fnn

    from mindpose_tpu_torch.models.common import BatchNorm2d

    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)  # NHWC
    if case == "large_mean":
        x = 10.0 + 0.1 * x
    else:
        x = 0.5 + 2.0 * x
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = (0.2 * rng.standard_normal(3)).astype(np.float32)
    ra_mean = (0.2 * rng.standard_normal(3)).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}
    want, updates = bn.apply(variables, xb, mutable=["batch_stats"])
    assert want.dtype == jnp.bfloat16

    port = BatchNorm2d(3).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(ra_mean))
        port.running_var.copy_(torch.from_numpy(ra_var))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).permute(0, 3, 1, 2).bfloat16()
    got = port(xt)
    assert got.dtype == torch.bfloat16

    got_f = got.float().permute(0, 2, 3, 1).detach().numpy()
    want_f = np.asarray(want.astype(jnp.float32))
    ulp = np.maximum(np.abs(want_f), np.abs(got_f))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(ulp, 1e-30))) - 7)  # bf16: 8 significand bits
    assert np.all(np.abs(got_f - want_f) <= ulp)

    stats = updates["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-6, atol=1e-7)
    x2 = float(np.mean(np.square(np.asarray(xb.astype(jnp.float32)))))
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=0, atol=0.1 * 8 * np.finfo(np.float32).eps * x2)
    # the batch variance really is there: bf16 statistics would read 0
    batch_var = (port.running_var.numpy() - 0.9 * ra_var) / 0.1
    assert np.all(batch_var > 0.005 if case == "large_mean" else batch_var > 1.0)


@pytest.mark.parametrize("case", ["normal", "large_mean"])
def test_float64_train_batch_norm_stays_float64(case):
    """Train-mode BN on a float64 net takes its statistics in float64, as
    flax does (statistics in ``promote_types(float32, x.dtype)``): the
    output and running statistics agree with numpy's float64 to 1e-12,
    where float32 statistics would be off by ~1e-6 (``large_mean`` cancels
    E[x^2] ~ 100 down to a variance of ~0.01)."""
    from mindpose_tpu_torch.models.common import BatchNorm2d

    rng = np.random.RandomState(4)
    x = rng.standard_normal((4, 3, 8, 8))  # NCHW, float64
    x = 10.0 + 0.1 * x if case == "large_mean" else 0.5 + 2.0 * x
    scale = rng.uniform(0.5, 1.5, 3)
    bias = 0.2 * rng.standard_normal(3)
    port = BatchNorm2d(3).double().train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float64 and port.running_var.dtype == torch.float64

    mean = x.mean(axis=(0, 2, 3))
    var = (x * x).mean(axis=(0, 2, 3)) - mean * mean
    want = ((x - mean[None, :, None, None]) * (scale / np.sqrt(var + 1e-5))[None, :, None, None]
            + bias[None, :, None, None])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.running_mean.numpy(), 0.1 * mean, rtol=1e-14)
    np.testing.assert_allclose(port.running_var.numpy(), 0.9 + 0.1 * var, rtol=1e-14)
