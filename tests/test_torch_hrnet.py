"""Port's HRNet + hrnet_head against the JAX package's, on the same weights.

A reduced HRNet (width 8, 1-2 modules per stage, 1-2 blocks per branch, all
four stages, so every transition and fusion shape occurs) is built in JAX,
given non-trivial BN parameters and running statistics, carried into the
port with the port's own converter, and both are run on the same input.
Heatmaps agree to atol 1e-4: both are float32 on the CPU, but the two
libraries sum each convolution in a different order.

``remat: true`` (each exchange unit recomputed in the backward, as JAX's
``nn.remat(HRModule)``): one float64 train step of the reduced net with it
equals the step without it, bit for bit (loss, every gradient, the running
statistics, updated once), and equals JAX's remat step within 1e-6 of each
tensor's largest entry (measured: 5.4e-8).
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
from mindpose_tpu.models.loss import mse as jax_mse_module
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.parallel.train import accum_loss_and_grads as jax_accum
from mindpose_tpu_torch.models import (
    create_backbone,
    create_decoder,
    create_eval_network,
    create_loss,
    create_network,
    create_network_with_loss,
)
from mindpose_tpu_torch.models.backbones.hrnet import HRModule, HRNet, w_cfg
from mindpose_tpu_torch.models.common import BatchNorm2d, resize_nearest
from mindpose_tpu_torch.models.convert import convert_net_variables, hrnet_mapping
from mindpose_tpu_torch.models.heads import HRNetHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.parallel import accum_loss_and_grads
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_bottomup_loss import Float64Numpy

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


def skeleton() -> Net:
    """The reduced net's structure on the meta device: what the converter reads."""
    with torch.device("meta"):
        return Net(HRNet(CFG), HRNetHead(8, 17))


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
    port.load_state_dict(convert_net_variables(variables, port), strict=True)
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
        {"params": variables["params"], "batch_stats": jax.device_get(updates["batch_stats"])}, net)
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
    with torch.device("meta"):  # the names only: no weights drawn
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
    # exact TPU rewrites and the fused-backward BN are plain BN here (built on
    # the meta device: the structure only)
    with torch.device("meta"):
        create_network("hrnet_w32", "hrnet_head",
                       backbone_args={"stem_s2d": True, "branch0_s2d": True,
                                      "bn_grad_stats": "fused"})
    # the divergent BatchNorm modes build, every BatchNorm in the mode
    # (tests/test_torch_divergent_knobs.py holds them to JAX)
    for knobs, want in (({"bn_grad_stats": "frozen"}, (1.0, "frozen")),
                        ({"bn_stats_frac": 0.25}, (0.25, "exact"))):
        with torch.device("meta"):
            backbone = create_backbone("hrnet_w32", **knobs)
        assert {(m.stats_frac, m.grad_stats) for m in backbone.modules()
                if isinstance(m, BatchNorm2d)} == {want}
    with pytest.raises(ValueError, match="bn_grad_stats"):
        create_backbone("hrnet_w32", bn_grad_stats="frozen_mean")
    # remat builds, with every exchange unit recomputed (the step: below)
    with torch.device("meta"):
        units = [m for m in create_backbone("hrnet_w32", remat=True).modules()
                 if isinstance(m, HRModule)]
    assert len(units) == 8 and all(m.remat for m in units)
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


# of each tensor's largest entry, port remat against JAX remat in float64
# (measured: 5.4e-8, a gradient of transition2; the loss 3e-16)
REMAT_RTOL = 1e-6


def _renamed(tree, old, new):
    """A flax tree with each scope ``old...`` named ``new...``: flax names a
    remat unit's scope ``CheckpointHRModule_i`` where the plain net has
    ``HRModule_i``."""
    if not isinstance(tree, dict):
        return tree
    return {(new + k[len(old):] if k.startswith(old) else k): _renamed(v, old, new)
            for k, v in tree.items()}


def _remat_step(variables, remat, image, target, weight):
    """One float64 forward and backward of the reduced net (port), from the
    converted JAX variables: the loss vector, the gradients, the state_dict
    after it, and how many times each BatchNorm's forward ran."""
    net = Net(HRNet(CFG, remat=remat), HRNetHead(8, 17))
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    net.double()
    nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    calls = []
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(lambda *_: calls.append(None))
    loss = accum_loss_and_grads(nwl, (image, target, weight))
    return (loss, {n: p.grad for n, p in net.named_parameters()}, net.state_dict(), len(calls),
            sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules()))


def test_remat_step_equals_the_plain_step_and_jax_s_remat_step(pair, monkeypatch):
    """Remat recomputes each exchange unit's forward in the backward (the
    BatchNorm forwards of stages 2-4 run twice), yet the step is the plain
    step bit for bit and the running statistics took one update; JAX's
    ``remat=True`` step in float64 (its loss's float32 casts lifted) on the
    same batch agrees within ``REMAT_RTOL`` of each tensor's largest entry."""
    _, variables, _, x = pair
    rng = np.random.RandomState(7)
    target = rng.uniform(0, 1, (2, 16, 12, 17))  # NHWC, as the JAX net's output
    weight = rng.uniform(0, 1, (2, 17))
    batch = (torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2).contiguous(),
             torch.from_numpy(target).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(weight))
    loss, grads, state, calls, norms = _remat_step(variables, True, *batch)
    loss0, grads0, state0, calls0, _ = _remat_step(variables, False, *batch)
    assert calls0 == norms < calls  # the recompute ran the BatchNorm forwards again
    assert torch.equal(loss, loss0)
    for name, g in grads0.items():
        assert torch.equal(grads[name], g), name
    for name, v in state0.items():
        assert torch.equal(state[name], v), name  # one update of the running statistics

    monkeypatch.setattr(jax_mse_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        jax_net = JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(CFG), dtype=jnp.float64,
                                           remat=True),
                         head=JaxHRNetHead(in_channels=8, num_joints=17, dtype=jnp.float64))
        nwl_j = jax_create_nwl(jax_net, jax_create_loss("joint_mse", use_target_weight=True),
                               has_extra_inputs=True)
        as64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
        remat_vars = _renamed(unfreeze(variables), "HRModule_", "CheckpointHRModule_")
        loss_j, stats_j, grads_j = jax.jit(lambda p, s, *b: jax_accum(nwl_j, p, s, b))(
            as64(remat_vars["params"]), as64(remat_vars["batch_stats"]),
            jnp.asarray(x, jnp.float64), jnp.asarray(target), jnp.asarray(weight))
        grads_j, stats_j = (_renamed(jax.device_get(t), "CheckpointHRModule_", "HRModule_")
                            for t in (grads_j, stats_j))
        want_g = convert_net_variables({"params": grads_j, "batch_stats": stats_j}, skeleton())
        want = convert_net_variables({"params": variables["params"], "batch_stats": stats_j},
                                     skeleton())
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=REMAT_RTOL)
    for name, g in grads.items():
        w = want_g[name].double()
        assert float((g - w).abs().max()) <= REMAT_RTOL * float(w.abs().max()), name
    for name, v in want.items():
        if name.endswith(("running_mean", "running_var")):
            w = v.double()
            assert float((state[name] - w).abs().max()) <= REMAT_RTOL * float(w.abs().max()), name
