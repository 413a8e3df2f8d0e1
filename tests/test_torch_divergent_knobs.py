"""The JAX package's divergent training knobs in the port, against JAX on the CPU.

- BatchNorm: JAX's ``batch_norm`` (flax ``nn.BatchNorm``, ``FusedBatchNorm``
  or ``SubsampledBatchNorm``, by mode and fraction) against the port's
  ``BatchNorm2d`` for each ``grad_stats`` x ``stats_frac`` in {1, 0.5, 0.25}
  x N in {2, 6, 8}: the forward, the running statistics and the gradients
  of the input, scale and bias within 1e-10 in float64 (JAX's float32 casts
  lifted, ``Float64Numpy``), and the bf16 forward within 3 bf16 ulps of the
  largest of |x mul|, |add| and |y| (each of mul, add and the two
  operations may round to the neighbouring bf16 value); ``fused`` with a
  fraction is exact BN; JAX's s2d stem (``ParityGroupBatchNorm``) at
  ``bn_stats_frac`` 0.25 equals the port's plain stem in float64; under
  ``sync_group`` on 2 gloo ranks the subsampled statistics are the global
  batch's leading rows (``tests/fixtures/divergent_ranks.py``).
- The radial projection: ``radial_projection_mask`` equals JAX's leaf for
  leaf through the converter, with each filter's output-channel dim, on
  tiny HRNet + ``hrnet_head``, ResNet + ``simple_baseline_head``,
  HigherHRNet and ViTPose; three ``RadialAdamW`` steps equal optax's chain
  within 1e-6 in float32 (weight decay off biases and norms; ``layer_decay``
  on the tiny ViTPose); a non-adamw optimizer raises JAX's error; sharded by
  FSDP on 2 gloo ranks along a summed dim, the steps equal one process's.
- One step of the reduced HRNet with ``frozen_var`` + ``bn_stats_frac`` 0.5
  + the radial projection, and with ``frozen``, against JAX's step: the
  first two losses within 1e-4, the running statistics, and the parameters
  after the first update (``close_update``: Adam's first update is
  lr * sign(g), so gradients within rounding of 0 flip).
- A JAX net built with ``bn_stats_frac`` 0.25 and ``bn_grad_stats`` frozen
  converts and computes JAX's train-mode forward.
- The gate: the entry exits without ``allow_divergent_knobs`` and warns
  with it (the copy of ``check_divergent_knobs`` is pinned in
  tests/test_torch_host_copies.py).
"""
import functools
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from mindpose_tpu.data.device_pipeline import build_topdown_preprocess as jax_build_preprocess
from mindpose_tpu.models import common as jax_common
from mindpose_tpu.models.backbones import s2d as jax_s2d
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.backbones.resnet import ResNet as JaxResNet
from mindpose_tpu.models.backbones.vit import ViT as JaxViT
from mindpose_tpu.models.heads import HigherHRNetHead as JaxHigherHead
from mindpose_tpu.models.heads.hrnet_head import HRNetHead as JaxHRNetHead
from mindpose_tpu.models.heads.simple_baseline_head import SimpleBaselineHead as JaxSBHead
from mindpose_tpu.models.loss import mse as jax_mse
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.optim.optim_factory import radial_projection_mask as jax_radial_mask
from mindpose_tpu.parallel.train import build_train_step as jax_build_train_step
from mindpose_tpu.parallel.train import create_train_state
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
from mindpose_tpu_torch.models import create_loss, create_network_with_loss
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.backbones.resnet import ResNet
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.common import BatchNorm2d
from mindpose_tpu_torch.models.convert import convert_net_variables, convert_variables, hrnet_mapping
from mindpose_tpu_torch.models.heads import HigherHRNetHead, HRNetHead, SimpleBaselineHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.optim.optim_factory import RadialAdamW, radial_projection_mask
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.tools import train as port_train
from tests.fixtures.ddp_ranks import start_ranks
from tests.fixtures.divergent_ranks import BN_CASES, FSDP_STEPS, bn_inputs, radial_module
from tests.fixtures.jax_tools import Float64Numpy
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_bench_steps import close_update
from tests.test_torch_hrnet import CFG
from tests.test_torch_train_entry import _args
from tests.test_torch_train_entry_jax_loop import data  # noqa: F401  (fixture)
from tests.test_torch_train_step import HEATMAP_SIZE, IMAGE_SIZE, MEAN, STD, _keypoints
from tests.test_torch_vit import TINY, fill_variables

F64_ATOL = 1e-10
LR = 1e-3  # close_update's rate
MODES = ("exact", "fused", "frozen", "frozen_var")
# the train-step tests' HRNet: CFG's widths and stages, one module and one block a branch
STEP_CFG = {**CFG, "stage3": {**CFG["stage3"], "num_blocks": (1, 1, 1)},
            "stage4": {**CFG["stage4"], "num_modules": 1, "num_blocks": (1, 1, 1, 1)}}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture
def jax_float64(monkeypatch):
    """JAX's BatchNorm modules with their float32 casts read as float64."""
    monkeypatch.setattr(jax_common, "jnp", Float64Numpy())
    monkeypatch.setattr(jax_s2d, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        yield


def _port_bn(frac, mode, inputs, dtype=torch.float64) -> BatchNorm2d:
    bn = BatchNorm2d(inputs["x"].shape[-1], frac, mode).to(dtype).train()
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(inputs[key]))
    return bn


def _jax_bn_variables(inputs, dtype):
    return ({"scale": jnp.asarray(inputs["scale"], dtype), "bias": jnp.asarray(inputs["bias"], dtype)},
            {"mean": jnp.asarray(inputs["mean"], dtype), "var": jnp.asarray(inputs["var"], dtype)})


# ---- BatchNorm, one module ----

@pytest.mark.parametrize("n", [2, 6, 8])
@pytest.mark.parametrize("frac", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("mode", MODES)
def test_batch_norm_matches_jax(mode, frac, n, jax_float64):
    inputs = bn_inputs(n, seed=100 * n + int(8 * frac))
    params, stats = _jax_bn_variables(inputs, jnp.float64)
    bn_j = jax_common.batch_norm(True, jnp.float64, stats_frac=frac, grad_stats=mode)

    def loss(params, x):
        y, upd = bn_j.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * inputs["r"]), (y, upd["batch_stats"])

    (_, (want, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(inputs["x"]))

    bn = _port_bn(frac, mode, inputs)
    assert bn.subsampled == (mode in ("frozen", "frozen_var") or (mode == "exact" and frac < 1))
    x = _nchw(inputs["x"]).requires_grad_()
    y = bn(x)
    (y * _nchw(inputs["r"])).sum().backward()
    for got, want_ in ((_nhwc(y), want), (_nhwc(x.grad), want_gx),
                       (bn.weight.grad.numpy(), want_gp["scale"]),
                       (bn.bias.grad.numpy(), want_gp["bias"]),
                       (bn.running_mean.numpy(), want_stats["mean"]),
                       (bn.running_var.numpy(), want_stats["var"])):
        np.testing.assert_allclose(got, np.asarray(want_), rtol=0, atol=F64_ATOL)
    # the frozen modes' gradients really differ from exact BN's
    if mode != "exact" and mode != "fused" and frac == 1.0:
        exact = _port_bn(1.0, "exact", inputs)
        xe = _nchw(inputs["x"]).requires_grad_()
        (exact(xe) * _nchw(inputs["r"])).sum().backward()
        assert float((xe.grad - x.grad).abs().max()) > 1e-3

    # bf16, as under autocast: bf16 in, float32 parameters, bf16 out
    with jax.enable_x64(False):
        xb = jnp.asarray(inputs["x"], jnp.bfloat16)
        params32, stats32 = _jax_bn_variables(inputs, jnp.float32)
        want_b, _ = jax_common.batch_norm(True, jnp.bfloat16, stats_frac=frac, grad_stats=mode).apply(
            {"params": params32, "batch_stats": stats32}, xb, mutable=["batch_stats"])
        assert want_b.dtype == jnp.bfloat16
        x32 = np.asarray(xb.astype(jnp.float32))
        want_b = np.asarray(want_b.astype(jnp.float32))
    bn32 = _port_bn(frac, mode, {k: v.astype(np.float32) for k, v in inputs.items()},
                    torch.float32)
    with torch.no_grad():
        got_b = bn32(_nchw(x32).bfloat16())
    assert got_b.dtype == torch.bfloat16
    got_b = _nhwc(got_b)
    # the per-channel affine from float64 statistics: |x mul| and |add| scale the rounding
    rows = max(1, int(round(n * frac))) if bn.subsampled else n
    xs = inputs["x"][:rows].reshape(-1, x32.shape[-1])
    mean, var = xs.mean(0), xs.var(0)
    mul = inputs["scale"] / np.sqrt(var + 1e-5)
    add = inputs["bias"] - mean * mul
    top = np.maximum(np.maximum(np.abs(x32 * mul), np.abs(add)), np.abs(want_b))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    assert np.all(np.abs(got_b - want_b) <= 3 * ulp), float(np.max(np.abs(got_b - want_b) / ulp))


def test_fused_ignores_the_fraction():
    """``fused`` at 0.25 is exact BN: the same output, gradients and running
    statistics bit for bit, as JAX's ``batch_norm`` returns ``FusedBatchNorm``
    and never reads ``stats_frac`` there."""
    inputs = bn_inputs(8, seed=7)
    outs = []
    for frac, mode in ((0.25, "fused"), (1.0, "exact")):
        bn = _port_bn(frac, mode, inputs)
        assert not bn.subsampled
        x = _nchw(inputs["x"]).requires_grad_()
        y = bn(x)
        (y * _nchw(inputs["r"])).sum().backward()
        outs.append([y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # at 0.25 the subsampled statistics are other ones
    sub = _port_bn(0.25, "exact", inputs)
    assert not torch.equal(sub(_nchw(inputs["x"])), outs[1][0])


class _JaxS2DStem(fnn.Module):
    frac: float

    @fnn.compact
    def __call__(self, x):
        return jax_s2d.s2d_stem_apply(x, True, jnp.float64, 3, stats_frac=self.frac)


def test_s2d_bn4_stem_matches_the_plain_stem(jax_float64):
    """JAX's s2d stem (``bench_variant``'s ``s2d_bn4``: ``ParityGroupBatchNorm``,
    the parity groups folded into the reduction) at ``bn_stats_frac`` 0.25
    against the port's HRNet stem with the same fraction, in float64: the
    output, the running statistics and the input's gradient."""
    rng = np.random.RandomState(11)
    x = rng.standard_normal((8, 32, 24, 3))
    r = rng.standard_normal((8, 8, 6, 64))
    stem = _JaxS2DStem(0.25)
    shapes = jax.eval_shape(lambda: stem.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 24, 3))))
    variables = jax.tree.map(np.asarray, fill_variables(shapes, rng))
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

    def loss(x):
        y, upd = stem.apply(variables, x, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (_, (want, want_stats)), want_gx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))

    net = HRNet(CFG, bn_stats_frac=0.25).double().train()
    stem_sd = convert_variables(variables, hrnet_mapping(CFG)[:4])
    missing, unexpected = net.load_state_dict(stem_sd, strict=False)
    assert not unexpected and not any(k.startswith(("conv1", "bn1", "conv2", "bn2"))
                                      for k in missing)
    xt = _nchw(x).requires_grad_()
    y = torch.relu(net.bn2(net.conv2(torch.relu(net.bn1(net.conv1(xt))))))
    (y * _nchw(r)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_gx), rtol=0, atol=F64_ATOL)
    for bn, name in ((net.bn1, "stem_bn1"), (net.bn2, "stem_bn2")):
        np.testing.assert_allclose(bn.running_mean.numpy(), want_stats[name]["mean"],
                                   rtol=0, atol=F64_ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), want_stats[name]["var"],
                                   rtol=0, atol=F64_ATOL)


# ---- FSDP: 2 gloo ranks ----

@pytest.fixture(scope="module")
def fsdp_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("divergent_ranks")
    start_ranks("fsdp", 2, str(out), timeout=300, module="tests.fixtures.divergent_ranks")
    return [torch.load(out / f"fsdp_rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("case", BN_CASES, ids=lambda c: f"{c[1]}-{c[0]}")
def test_fsdp_subsampled_statistics_are_the_global_batch_s(fsdp_ranks, case):
    """Each rank holds half of a global batch of 6 under ``sync_group``: the
    statistics come from the global batch's leading rows (0.25: 2 rows, all
    on rank 0; 0.5: 3, rank 0's; 0.75: 4, across both), as one process on
    the whole batch takes them: the output, the input's gradient, the summed
    scale and bias gradients and every rank's running statistics."""
    frac, mode = case
    inputs = bn_inputs(6, seed=31)
    bn = _port_bn(frac, mode, inputs)
    x = _nchw(inputs["x"]).requires_grad_()
    y = bn(x)
    (y * _nchw(inputs["r"])).sum().backward()
    got = [r["bn"][case] for r in fsdp_ranks]
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(), rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.cat([g["x_grad"] for g in got]), x.grad, rtol=0, atol=1e-12)
    for key, want in (("weight_grad", bn.weight.grad), ("bias_grad", bn.bias.grad)):
        torch.testing.assert_close(got[0][key] + got[1][key], want, rtol=0, atol=1e-12)
    for g in got:
        torch.testing.assert_close(g["running_mean"], bn.running_mean, rtol=0, atol=1e-12)
        torch.testing.assert_close(g["running_var"], bn.running_var, rtol=0, atol=1e-12)


def test_fsdp_radial_adamw_covers_the_whole_filter(fsdp_ranks):
    """A conv sharded along its input channels and a transposed conv along
    its input channels (both summed dims): ``FSDP_STEPS`` steps on 2 ranks
    equal one process on the global batch; without the all-reduce of the
    shards' sums they would not (the per-channel norm is then a shard's)."""
    module, batches = radial_module()
    opt = RadialAdamW([{"params": [module[0].weight], "radial_dim": 0},
                       {"params": [module[1].weight], "radial_dim": 1},
                       {"params": [module[0].bias, module[1].bias]}],
                      lr=1e-2, weight_decay=0.1)
    for x in batches:
        opt.zero_grad()
        module(x).square().mean().backward()
        opt.step()
    shards = fsdp_ranks[0]["radial"]
    assert shards["placements"] == {"0.weight": 1, "1.weight": 0}
    for name, p in module.state_dict().items():
        torch.testing.assert_close(shards["params"][name], p, rtol=0, atol=1e-12)


# ---- the radial projection ----

def _hrnet_pair(head):
    backbone = JaxHRNet(stage_cfg=_freeze_cfg(CFG))
    if head == "higher":
        return (JaxNet(backbone=backbone, head=JaxHigherHead(in_channels=8, num_deconv_filters=(16,))),
                Net(HRNet(CFG), HigherHRNetHead(in_channels=8, num_deconv_filters=(16,),
                                                s2d_refine=True)), (64, 48))
    return (JaxNet(backbone=backbone, head=JaxHRNetHead(in_channels=8, num_joints=17)),
            Net(HRNet(CFG), HRNetHead(8, 17)), (64, 48))


def _pairs(name):
    """(JAX net, port net, input HW) of the four families."""
    if name in ("hrnet", "higher"):
        return _hrnet_pair(name)
    if name == "resnet":
        head = dict(num_deconv_filters=(16, 16, 16))
        return (JaxNet(backbone=JaxResNet(block_counts=(1, 1, 1, 1)), head=JaxSBHead(**head)),
                Net(ResNet((1, 1, 1, 1)), SimpleBaselineHead(**head)), (64, 48))
    head = dict(num_deconv_layers=2, num_deconv_filters=(16, 16), num_deconv_kernels=(4, 4),
                in_channels=TINY["hidden_dim"])
    return (JaxNet(backbone=JaxViT(**TINY), head=JaxSBHead(**head)),
            Net(ViT(image_size=(96, 128), **TINY), SimpleBaselineHead(**head)), (128, 96))


@functools.lru_cache(maxsize=None)
def _shapes(jax_net, hw):
    return jax.eval_shape(lambda: jax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)),
                                               train=False))


@pytest.mark.parametrize("family", ["hrnet", "resnet", "higher", "vitpose"])
def test_radial_mask_matches_jax(family):
    """Each masked flax leaf filled with its output-channel index + 1 (flax's
    last axis), every other leaf with 0, through the converter: the port's
    mask names exactly the nonzero tensors, and its dim is the one the index
    runs along."""
    jax_net, net, hw = _pairs(family)
    shapes = _shapes(jax_net, hw)
    mask = jax_radial_mask(shapes["params"])

    def fill(m, s):
        if not m:
            return np.zeros(s.shape, np.float32)
        return np.broadcast_to(np.arange(1, s.shape[-1] + 1, dtype=np.float32), s.shape)

    filled = convert_net_variables(
        {"params": jax.tree.map(fill, mask, shapes["params"]),
         "batch_stats": jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                     shapes.get("batch_stats", {}))}, net)
    got = radial_projection_mask(net)
    assert set(got) == set(dict(net.named_parameters()))
    masked = {n for n, d in got.items() if d is not None}
    assert masked == {n for n in got if bool(filled[n].any())}
    for name in masked:
        t, keep = filled[name], got[name]
        shape = [1] * t.dim()
        shape[keep] = t.shape[keep]
        assert torch.equal(t, torch.arange(1, t.shape[keep] + 1, dtype=t.dtype)
                           .view(shape).expand_as(t)), name
    if family == "vitpose":
        assert got["backbone.pos_embed"] == 3 and got["backbone.patch_embed.proj.weight"] is None
    if family in ("resnet", "vitpose"):
        assert got["head.deconv_layers.0.weight"] == 1 and got["head.final_layer.weight"] is None
    if family == "higher":
        assert got["head.deconv_layers.0.3.conv1.weight"] == 0
        assert got["head.final_layers.1.weight"] is None


@pytest.mark.parametrize("family, settings", [
    ("higher", dict(weight_decay=0.05, filter_bias_and_bn=True)),
    ("vitpose", dict(weight_decay=0.1, filter_bias_and_bn=True, layer_decay=0.75)),
], ids=["higher-decay", "vitpose-layer_decay"])
def test_radial_adamw_three_steps_match_optax(family, settings):
    jax_net, net, hw = _pairs(family)
    rng = np.random.RandomState(41)
    variables = jax.tree.map(np.asarray, fill_variables(_shapes(jax_net, hw), rng))
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    params = variables["params"]
    tx = jax_create_optimizer(params, name="adamw", learning_rate=1e-3, radial_projection=True,
                              **settings)
    opt = create_optimizer(net, name="adamw", learning_rate=1e-3, radial_projection=True,
                           **settings)
    assert isinstance(opt, torch.optim.AdamW)
    named = dict(net.named_parameters())
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        params, state = update(grads, state, params)
        for name, g in convert_net_variables({"params": grads, "batch_stats":
                                              variables.get("batch_stats", {})}, net).items():
            if name in named:
                named[name].grad = g
        opt.step()
    want = convert_net_variables({"params": jax.device_get(params),
                                  "batch_stats": variables.get("batch_stats", {})}, net)
    start = convert_net_variables(variables, net)
    for name, p in named.items():
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=1e-6, msg=name)
        assert float((want[name] - start[name]).abs().max()) > 1e-4, name
    moments = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(moments) == 1 and all(float(opt.state[p]["step"]) == 3 for p in named.values())


@pytest.mark.parametrize("name", ["adam", "sgd", "momentum", "adagrad"])
def test_radial_projection_needs_adamw(name):
    shapes = _shapes(*_hrnet_pair("hrnet")[::2])
    with pytest.raises(ValueError) as want:
        jax_create_optimizer(shapes["params"], name=name, radial_projection=True)
    with pytest.raises(ValueError) as got:
        create_optimizer(_hrnet_pair("hrnet")[1], name=name, radial_projection=True)
    assert str(got.value) == str(want.value)


# ---- one train step of the reduced HRNet ----

@pytest.fixture(scope="module")
def hrnet_variables():
    """``STEP_CFG``'s variables from a numpy stream (``fill_variables``), the
    head's kernel drawn large enough to train."""
    shapes = _shapes(JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(STEP_CFG)),
                            head=JaxHRNetHead(in_channels=8, num_joints=17)), (64, 48))
    rng = np.random.RandomState(0)
    variables = jax.tree.map(np.asarray, fill_variables(shapes, rng))
    head = variables["params"]["head"]["head"]
    head["kernel"] = (0.2 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    return variables


@pytest.mark.parametrize("knobs, radial", [
    ({"bn_grad_stats": "frozen_var", "bn_stats_frac": 0.5}, True),
    ({"bn_grad_stats": "frozen"}, False),
], ids=["frozen_var-0.5-radial", "frozen"])
def test_train_step_matches_jax(hrnet_variables, knobs, radial, monkeypatch):
    """Two steps of adamw (1e-3, weight decay 0.05) on a batch of 4 at 64x48
    through each package's step and device preprocess: the port in float32,
    JAX in float64. JAX's own float32 step is the outlier with ``frozen``:
    its second loss is 2.7e-3 of itself from its float64 step's, which the
    port's float32 step matches to 1.3e-7."""
    variables = hrnet_variables
    monkeypatch.setattr(jax_common, "jnp", Float64Numpy())
    monkeypatch.setattr(jax_mse, "jnp", Float64Numpy())
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (4, 64, 48, 3)).astype(np.uint8)
    kpts = _keypoints(rng, 4)
    optim = dict(name="adamw", learning_rate=LR, weight_decay=0.05, radial_projection=radial)

    with jax.enable_x64(True):
        jax_net = JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(STEP_CFG), dtype=jnp.float64, **knobs),
                         head=JaxHRNetHead(in_channels=8, num_joints=17, dtype=jnp.float64))
        nwl_j = jax_create_nwl(jax_net, jax_create_loss("joint_mse", use_target_weight=True),
                               has_extra_inputs=True)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = jax_create_optimizer(v64["params"], **optim)
        state = create_train_state(v64, tx)
        step_j = jax_build_train_step(nwl_j, tx, donate=False, preprocess=jax_build_preprocess(
            IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0))
        jax_losses, updated = [], None
        for _ in range(2):
            state, loss = step_j(state, jnp.asarray(image), jnp.asarray(kpts))
            jax_losses.append(float(np.asarray(loss).sum()))
            if updated is None:
                updated, stats = jax.device_get(state.params), jax.device_get(state.batch_stats)

    net = Net(HRNet(STEP_CFG, **knobs), HRNetHead(8, 17))
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    step = build_train_step(nwl, create_optimizer(net, **optim), preprocess=build_topdown_preprocess(
        IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0))
    losses, after = [], None
    for _ in range(2):
        losses.append(float(step(torch.from_numpy(image), torch.from_numpy(kpts)).sum()))
        if after is None:
            after = {n: p.detach().clone() for n, p in net.named_parameters()}
            running = {n: t.clone() for n, t in net.state_dict().items() if "running" in n}
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    close_update(after, SimpleNamespace(variables=variables, updated=updated), net)
    want = convert_net_variables({"params": updated, "batch_stats": stats}, net)
    for name, t in running.items():
        torch.testing.assert_close(t, want[name], rtol=1e-4, atol=1e-5, msg=name)


def test_jax_net_with_the_knobs_converts(hrnet_variables):
    """JAX names SubsampledBatchNorm ``BatchNorm_i``: a net built with
    ``bn_stats_frac`` 0.25 and ``bn_grad_stats`` frozen has exact BN's
    variables, converts, and the port's net with the same knobs computes its
    train-mode forward (batch 8: statistics from 2 samples) and running
    statistics."""
    knobs = {"bn_stats_frac": 0.25, "bn_grad_stats": "frozen"}
    jax_net = JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(STEP_CFG), **knobs),
                     head=JaxHRNetHead(in_channels=8, num_joints=17))
    x = np.random.RandomState(3).standard_normal((8, 64, 48, 3)).astype(np.float32)
    plain = _shapes(JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(STEP_CFG)),
                           head=JaxHRNetHead(in_channels=8, num_joints=17)), (64, 48))
    assert jax.tree.structure(_shapes(jax_net, (64, 48))) == jax.tree.structure(plain)
    variables = hrnet_variables
    want, upd = jax.jit(lambda v, x: jax_net.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    net = Net(HRNet(STEP_CFG, **knobs), HRNetHead(8, 17)).train()
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    with torch.no_grad():
        got = net(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    stats = convert_net_variables({"params": variables["params"],
                                   "batch_stats": jax.device_get(upd["batch_stats"])}, net)
    for name, t in net.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(t, stats[name], rtol=1e-4, atol=1e-5, msg=name)


# ---- the gate ----

DIVERGENT = {"backbone_setting": {"bn_grad_stats": "frozen_var", "bn_stats_frac": 0.5},
             "optimizer_setting": {"radial_projection": True}}


def test_entry_exits_without_the_flag_and_warns_with_it(data, tmp_path, caplog,  # noqa: F811
                                                       monkeypatch):
    """Without ``allow_divergent_knobs`` the entry exits with JAX's text before
    it builds anything; with it, one warning per knob, and the net's
    BatchNorms and the optimizer take the settings."""
    built = {}
    for name in ("create_network", "create_optimizer"):
        def keep(*a, _name=name, _real=getattr(port_train, name), **k):
            built[_name] = _real(*a, **k)
            return built[_name]
        monkeypatch.setattr(port_train, name, keep)
    args = _args(str(tmp_path), data, num_epochs=1, val_while_train=False, **DIVERGENT)
    with pytest.raises(SystemExit, match="allow_divergent_knobs=true"):
        port_train.train(args)
    assert not built
    args = Config(**dict(vars(args), allow_divergent_knobs=True))
    with caplog.at_level(logging.WARNING):
        got = port_train.train(args)
    warned = [r.getMessage() for r in caplog.records if "divergent knob enabled" in r.getMessage()]
    assert len(warned) == 2 and "bn_grad_stats='frozen_var'" in warned[0]
    assert {(m.stats_frac, m.grad_stats) for m in built["create_network"].backbone.modules()
            if isinstance(m, BatchNorm2d)} == {(0.5, "frozen_var")}
    assert isinstance(built["create_optimizer"], RadialAdamW)
    (epoch,) = got["epochs"]
    assert np.isfinite(epoch["loss"])
