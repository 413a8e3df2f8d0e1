"""The port's top-down train step against the JAX package's, on the CPU.

Pieces first (targets, preprocess, loss, schedules, optimizers), then the
whole step on the reduced HRNet of tests/test_torch_hrnet.py (``CFG``,
width 8), whose weights go from JAX to the port with
``convert_net_variables``. Both run float32 on the CPU but convolve and sum
in different orders, so values agree to stated tolerances, not bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mindpose_tpu.data.device_pipeline import build_topdown_preprocess as jax_build_preprocess
from mindpose_tpu.data.device_pipeline import strip_host_target_transform as jax_strip
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.heads.hrnet_head import HRNetHead as JaxHRNetHead
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.ops.target import generate_topdown_targets as jax_targets
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.optim.optim_factory import decay_mask as jax_decay_mask
from mindpose_tpu.parallel.train import accum_loss_and_grads as jax_accum
from mindpose_tpu.parallel.train import build_ema_update as jax_build_ema
from mindpose_tpu.parallel.train import build_train_step as jax_build_train_step
from mindpose_tpu.parallel.train import create_train_state
from mindpose_tpu.scheduler.schedulers import create_lr_scheduler as jax_create_scheduler
from mindpose_tpu_torch.data.device_pipeline import (
    build_topdown_preprocess,
    strip_host_target_transform,
)
from mindpose_tpu_torch.models import create_loss, create_network_with_loss
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.convert import convert_net_variables, hrnet_mapping
from mindpose_tpu_torch.models.heads import HRNetHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.ops.target import generate_topdown_targets
from mindpose_tpu_torch.optim import create_optimizer, decay_mask
from mindpose_tpu_torch.parallel import accum_loss_and_grads, build_ema_update, build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from tests.test_torch_hrnet import CFG, _randomize, skeleton
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

IMAGE_SIZE = (48, 64)  # (W, H) of the reduced net's input crops
HEATMAP_SIZE = (12, 16)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _keypoints(rng, n, k=17, w=48.0, h=64.0):
    """[n, k, 3]: mostly inside the crop, some outside the heatmap's reach,
    x and y on the .5 boundaries of the heatmap grid (stride 4), vis 0/1."""
    xy = rng.uniform([-30, -30], [w + 30, h + 30], (n, k, 2))
    xy[0, :6] = [[2.0, 6.0], [6.0, 10.0], [10.0, 2.0], [14.0, 14.0], [18.0, 30.0], [22.0, 26.0]]
    xy[1, :3] = [[-80.0, 5.0], [w + 80.0, 9.0], [5.0, -80.0]]  # windows that miss the map
    xy[1, 3:6] = [[-30.0, 5.0], [w + 22.0, 9.0], [5.0, -31.0]]  # at the edge of missing
    vis = rng.randint(0, 2, (n, k, 1))
    vis[:2, :6] = 1
    return np.concatenate([xy, vis], -1).astype(np.float32)


# ------------------------------------------------------------------- pieces


@pytest.mark.parametrize("use_udp", [False, True])
@pytest.mark.parametrize("sigma", [2.0, 3.0])
def test_topdown_targets_match_jax(use_udp, sigma):
    """Same support and weights exactly; values to 5e-6 (XLA may contract the
    sum of squares into fused multiply-adds and has its own exp)."""
    k = _keypoints(np.random.RandomState(1), 6)
    want_t, want_w = jax_targets(jnp.asarray(k), HEATMAP_SIZE, IMAGE_SIZE, sigma=sigma,
                                 use_udp=use_udp)
    got_t, got_w = generate_topdown_targets(torch.from_numpy(k), HEATMAP_SIZE, IMAGE_SIZE,
                                            sigma=sigma, use_udp=use_udp)
    want_t = np.asarray(want_t).transpose(0, 3, 1, 2)  # NHWC -> NCHW
    assert got_t.shape == (6, 17, 16, 12) and got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_t.numpy() > 0, want_t > 0)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=5e-6)
    # the boundary keypoints and the misses really are there
    assert np.asarray(want_w)[1, :3].sum() == 0 and np.asarray(want_w)[0, :6].all()


def test_preprocess_matches_jax():
    rng = np.random.RandomState(2)
    image = rng.randint(0, 256, (3, 64, 48, 3)).astype(np.uint8)
    k = _keypoints(rng, 3)
    want = jax_build_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0)(
        jnp.asarray(image), jnp.asarray(k))
    got = build_topdown_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0)(
        torch.from_numpy(image), torch.from_numpy(k))
    assert got[0].shape == (3, 3, 64, 48) and got[0].is_contiguous()
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).transpose(0, 3, 1, 2))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]).transpose(0, 3, 1, 2),
                               rtol=0, atol=5e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_strip_host_target_transform_is_the_original():
    cases = [
        ["topdown_box_to_center_scale", {"topdown_affine": {}},
         {"topdown_generate_target": {"sigma": 3.0, "use_udp": True}}],
        ["topdown_affine", "topdown_generate_target"],
        [{"topdown_generate_simcc_target": {"sigma": 6.0}}, "topdown_affine"],
        [{"topdown_generate_regression_target": None}],
        ["topdown_affine"],
    ]
    for transforms in cases:
        assert strip_host_target_transform(transforms) == jax_strip(transforms)


@pytest.mark.parametrize("use_target_weight", [False, True])
def test_joint_mse_matches_jax(use_target_weight):
    rng = np.random.RandomState(3)
    pred = rng.randn(3, 5, 8, 6).astype(np.float32)  # NCHW
    target = rng.rand(3, 5, 8, 6).astype(np.float32)
    weight = rng.randint(0, 2, (3, 5)).astype(np.float32) * 0.7
    want = jax_create_loss("joint_mse", use_target_weight=use_target_weight)(
        jnp.asarray(pred.transpose(0, 2, 3, 1)), jnp.asarray(target.transpose(0, 2, 3, 1)),
        jnp.asarray(weight))
    got = create_loss("joint_mse", use_target_weight=use_target_weight)(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(weight))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # the weight multiplies the squared error once
    if use_target_weight:
        assert np.isclose(got.item(), np.mean((pred - target) ** 2 * weight[:, :, None, None]))


def test_joint_mse_with_mask_matches_jax():
    rng = np.random.RandomState(4)
    pred = rng.randn(2, 4, 6, 5).astype(np.float32)
    target = rng.rand(2, 4, 6, 5).astype(np.float32)
    mask = rng.randint(0, 2, (2, 6, 5)).astype(np.float32)
    want = jax_create_loss("joint_mse_with_mask")(
        jnp.asarray(pred.transpose(0, 2, 3, 1)), jnp.asarray(target.transpose(0, 2, 3, 1)),
        jnp.asarray(mask))
    got = create_loss("joint_mse_with_mask")(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


SPE = 11  # steps per epoch of the schedule tests


@pytest.mark.parametrize("name,kwargs,steps,rtol", [
    ("warmup_multi_step_decay", {"milestones": [170, 200]},
     [0, 1, 250, 499, 500, 501] + [(m - 1) * SPE + d for m in (170, 200) for d in (-1, 0, 1)],
     0.0),
    # float32 cos of the two libraries may differ in the last bit
    ("warmup_cosine_decay", {"min_lr": 1e-5},
     [0, 1, 250, 499, 500, 501, 1000, 210 * SPE - 1, 210 * SPE, 210 * SPE + 5], 2.0**-22),
])
def test_schedules_match_jax(name, kwargs, steps, rtol):
    """Same float32 arithmetic: the multi-step schedule bit for bit."""
    want = jax_create_scheduler(name, lr=1e-3, total_epochs=210, steps_per_epoch=SPE,
                                warmup=500, **kwargs)
    got = create_lr_scheduler(name, lr=1e-3, total_epochs=210, steps_per_epoch=SPE,
                              warmup=500, **kwargs)
    for s in steps:
        assert abs(got(s) - float(want(s))) <= rtol * float(want(s)), s


# ------------------------------------------------------- the reduced HRNet


def _jax_net(dtype=jnp.float32):
    return JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(CFG), dtype=dtype),
                  head=JaxHRNetHead(in_channels=8, num_joints=17, dtype=dtype))


@pytest.fixture(scope="module")
def variables():
    rng = np.random.RandomState(0)
    init = jax.jit(lambda key, x: _jax_net().init(key, x, train=False))
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3), jnp.float32))
    variables = _randomize(variables, rng)
    # a trainable head: _randomize draws it tiny for the eval comparisons
    head = variables["params"]["head"]["head"]
    head["kernel"] = (0.2 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (4, 64, 48, 3)).astype(np.uint8)
    return image, _keypoints(rng, 4)


def _port_net(variables):
    net = Net(HRNet(CFG), HRNetHead(8, 17))
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    return net


def _flax_paths():
    """torch parameter name -> flax params path, for the reduced net."""
    paths = {"head.head.weight": ("head", "head", "kernel"),
             "head.head.bias": ("head", "head", "bias")}
    for kind, prefix, path in hrnet_mapping(CFG):
        full = ("backbone",) + path
        if kind == "conv":
            paths[f"backbone.{prefix}.weight"] = full + ("kernel",)
        else:
            paths[f"backbone.{prefix}.weight"] = full + ("scale",)
            paths[f"backbone.{prefix}.bias"] = full + ("bias",)
    return paths


def _params_sd(params, stats):
    """JAX params (or a gradient tree of their shape) as the port's state_dict."""
    return convert_net_variables({"params": params, "batch_stats": stats}, skeleton())


def _running_stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_decay_mask_matches_jax_by_module_type(variables):
    want = jax_decay_mask(variables["params"])
    got = decay_mask(_port_net(variables))
    paths = _flax_paths()
    assert set(got) == set(paths)
    for name, path in paths.items():
        leaf = want
        for key in path:
            leaf = leaf[key]
        assert got[name] == leaf, name
    assert got["backbone.bn1.weight"] is False and got["head.head.bias"] is False
    assert got["backbone.conv1.weight"] is True and got["head.head.weight"] is True


def _random_grads(params, rng):
    return jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


@pytest.mark.parametrize("name,filter_bias_and_bn", [
    ("adamw", True), ("adamw", False), ("adam", True), ("sgd", True), ("momentum", True),
    ("adagrad", True),
])
def test_optimizer_matches_optax_over_5_steps(variables, name, filter_bias_and_bn):
    """Identical gradients for 5 steps; weight decay 0.5 so that a parameter
    given the wrong decay group moves ~5e-3 away. Parameters agree to 2e-6
    (float32 rounding of 5 updates of ~1e-2)."""
    rng = np.random.RandomState(6)
    kw = dict(name=name, learning_rate=1e-2, weight_decay=0.5,
              filter_bias_and_bn=filter_bias_and_bn)
    params = variables["params"]
    tx = jax_create_optimizer(params, **kw)
    opt_state = tx.init(params)
    net = _port_net(variables)
    opt = create_optimizer(net, **kw)
    named = dict(net.named_parameters())
    for _ in range(5):
        grads = _random_grads(params, rng)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for key, g in _params_sd(grads, variables["batch_stats"]).items():
            if key in named:
                named[key].grad = g.clone()
        opt.step()
    want = _params_sd(params, variables["batch_stats"])
    start = _params_sd(variables["params"], variables["batch_stats"])
    moved = 0.0
    for key, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), rtol=0, atol=2e-6,
                                   err_msg=key)
        moved = max(moved, float((want[key] - start[key]).abs().max()))
    assert moved > 1e-2


@pytest.mark.parametrize("knob, error, match", [
    # the radial projection is ported, for adamw only, as in JAX
    # (tests/test_torch_divergent_knobs.py holds it to optax's chain)
    ({"radial_projection": True, "name": "adam"}, ValueError, "only supported with adamw"),
    # layer decay is ported, and needs a block-indexed (ViT) tree, as in JAX
    ({"layer_decay": 0.75}, ValueError, "block-indexed"),
])
def test_optimizer_refuses_unported_knobs(variables, knob, error, match):
    with pytest.raises(error, match=match):
        create_optimizer(_port_net(variables), **{"name": "adamw", **knob})


def test_train_step_refuses_unknown_amp_level(variables):
    net, nwl, _ = _port_side(variables)
    with pytest.raises(ValueError, match="amp_level"):
        build_train_step(nwl, create_optimizer(net), amp_level="O4")


def test_net_with_loss_runs_train_mode_after_eval(variables, batch):
    """An EvalNet over the same net leaves it in eval mode; the loss's
    forward puts it back in train mode, so BatchNorm takes batch statistics."""
    net, nwl, pp = _port_side(variables)
    net.eval()
    before = net.state_dict()["backbone.bn1.running_mean"].clone()
    loss = nwl(*pp(*(torch.from_numpy(a) for a in batch)))
    assert net.training and loss.shape == (1,)
    assert not torch.equal(net.state_dict()["backbone.bn1.running_mean"], before)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(7)
    ema = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    want = jax_build_ema(0.99)(ema, params)
    got = build_ema_update(0.99)({k: torch.from_numpy(v.copy()) for k, v in ema.items()},
                                 {k: torch.from_numpy(v) for k, v in params.items()})
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ the whole step

YAML = dict(name="adamw", weight_decay=0.05, filter_bias_and_bn=True)  # hrnet_w32_tpu.yaml


def _schedule_kwargs():
    # warmup 2 (the yaml's 500, shortened) and the yaml's milestones
    return dict(lr=1e-3, total_epochs=210, steps_per_epoch=1, warmup=2, milestones=[170, 200])


def _jax_side(dtype):
    nwl = jax_create_nwl(_jax_net(dtype), jax_create_loss("joint_mse", use_target_weight=True),
                         has_extra_inputs=True)
    pp = jax_build_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0)
    return nwl, pp


def _as(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _port_side(variables):
    net = _port_net(variables)
    nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    pp = build_topdown_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0)
    return net, nwl, pp


def _grad_errors(net, want_grads):
    """Per tensor: max|port - JAX| / max|JAX| of the gradients."""
    out = {}
    for name, p in net.named_parameters():
        w = want_grads[name]
        out[name] = float((p.grad - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def _adam_gradients(opt_state, mu_prev=None):
    """The gradient an optax adam step took, read back from its first moment:
    g_t = (mu_t - b1 mu_(t-1)) / (1 - b1), b1 = 0.9 (exact to float64
    rounding; no second compile of the forward and backward). Returns the
    gradient tree (numpy) and mu_t, to pass to the next call."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu = jax.device_get(adam.mu)
    if mu_prev is None:
        return jax.tree.map(lambda m: m / 0.1, mu), mu
    return jax.tree.map(lambda m, p: (m - 0.9 * p) / 0.1, mu, mu_prev), mu


def _adam_tolerance(want_g, start, lrs):
    """Per element: 1e-5, or 2 * sum(lr) where a step's JAX gradient is below
    1e-4 of its tensor's largest. Adam's first updates are about lr * sign(g),
    so where the float32 rounding of a near-zero gradient may flip its sign
    the parameter may move the other way."""
    tol = {}
    for name, g0 in start.items():
        tiny = torch.zeros_like(g0, dtype=torch.bool)
        for g in want_g:
            tiny |= g[name].abs() < 1e-4 * g[name].abs().max()
        tol[name] = torch.where(tiny, 2.0 * sum(lrs), 1e-5)
    return tol


def test_three_steps_match_jax(variables, batch):
    """The yaml's optimizer and schedule (warmup shortened to 2) for 3 steps.

    The reference is the JAX package's step run in float64: its own float32
    gradient on the CPU is off by up to 0.14 of a tensor's largest entry on
    this net (conv2 of stage3 branch 2), while the port's float32 gradient
    agrees with float64 to 5e-6 of it, and JAX float64 with the port's
    float64 to 1e-6 (the port renders its targets in float32). Losses agree to rtol 1e-5; the first step's gradients to
    1e-4 of each tensor's largest entry; BatchNorm running statistics to
    rtol 1e-4 (three batch statistics of float32 data); parameters as
    ``_adam_tolerance`` says.
    """
    image, kpts = batch
    it, kt = torch.from_numpy(image), torch.from_numpy(kpts)
    net, nwl, pp = _port_side(variables)
    schedule = create_lr_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
    step = build_train_step(nwl, create_optimizer(net, **YAML), schedule,
                            preprocess=pp)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}
    names = list(start)

    with jax.enable_x64(True):
        nwl_j, pp_j = _jax_side(jnp.float64)
        schedule_j = jax_create_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
        variables64 = {"params": _as(variables["params"], jnp.float64),
                       "batch_stats": _as(variables["batch_stats"], jnp.float64)}
        tx = jax_create_optimizer(variables64["params"], learning_rate=schedule_j, **YAML)
        state = create_train_state(variables64, tx)
        step_j = jax_build_train_step(nwl_j, tx, preprocess=pp_j, donate=False)
        ij, kj = jnp.asarray(image), jnp.asarray(kpts)
        want_g, lrs, mu = [], [], None
        for i in range(3):
            lrs.append(schedule(i))
            state, loss_j = step_j(state, ij, kj)
            g, mu = _adam_gradients(state.opt_state, mu)  # the gradient the step took
            want_g.append(_params_sd(g, variables["batch_stats"]))
            loss = step(it, kt)
            np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
            if i == 0:
                errs = _grad_errors(net, want_g[0])
                assert max(errs.values()) < 1e-4, max(errs, key=errs.get)
                # lr = schedule(0) = 0: the moments move, the parameters do not
                for name, p in net.named_parameters():
                    assert torch.equal(p.detach(), start[name]), name
        want = _params_sd(state.params, state.batch_stats)
    assert step.count == 3 and lrs == [0.0, schedule(1), schedule(2)] and lrs[2] > 0
    got = net.state_dict()
    for name, v in _running_stats(want).items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    tol = _adam_tolerance(want_g, start, lrs)
    loose = 0  # parameters that needed the loose tolerance
    for name in names:
        diff = (got[name] - want[name]).abs()
        assert bool((diff <= tol[name]).all()), (name, float(diff.max()))
        loose += int((diff > 1e-5).sum())
        assert float((want[name] - start[name]).abs().max()) > 1e-4  # every tensor moved
    # measured: 3 of 404,473 parameters beyond 1e-5, in stage 4's branch 3
    assert loose <= 1e-4 * sum(t.numel() for t in tol.values())


def test_accum_steps_2_matches_jax(variables, batch):
    """Two microbatches of 2: loss vector, averaged gradients and the running
    statistics threaded through both, against JAX in float64 (see above)."""
    image, kpts = batch
    net, nwl, pp = _port_side(variables)
    loss = accum_loss_and_grads(nwl, (torch.from_numpy(image), torch.from_numpy(kpts)),
                                accum_steps=2, preprocess=pp)
    with jax.enable_x64(True):
        nwl_j, pp_j = _jax_side(jnp.float64)
        loss_j, stats_j, g = jax.jit(lambda p, s, i, k: jax_accum(
            nwl_j, p, s, (i, k), accum_steps=2, preprocess=pp_j))(
            _as(variables["params"], jnp.float64), _as(variables["batch_stats"], jnp.float64),
            jnp.asarray(image), jnp.asarray(kpts))
        want_g = _params_sd(g, variables["batch_stats"])
        want_stats = _running_stats(_params_sd(variables["params"], stats_j))
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
    errs = _grad_errors(net, want_g)
    assert max(errs.values()) < 1e-4, max(errs, key=errs.get)
    got = net.state_dict()
    for name, v in want_stats.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match="divisible"):
        accum_loss_and_grads(nwl, (torch.from_numpy(image), torch.from_numpy(kpts)),
                             accum_steps=3, preprocess=pp)


def test_o2_step_matches_jax_bf16(variables, batch):
    """One O2 step (bf16 autocast, float32 BatchNorm statistics and loss)
    against the JAX net built with ``dtype=bfloat16``.

    Loose, because bf16 rounds at different places in the two: on this
    randomized reduced net each side's bf16 gradient is off from the float64
    one by a median of 0.23-0.31 of a tensor's largest entry (measured), and
    by as much from the other. So the test asks: the loss within 2e-3; each
    gradient tensor pointing the same way (cosine similarity >= 0.6, median
    >= 0.9); running statistics within 5e-2 of each tensor's largest (measured: 1e-2
    at most); and
    the step really ran in bf16 (its loss differs from the float32 one).
    """
    image, kpts = batch
    net, nwl, pp = _port_side(variables)
    schedule = create_lr_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
    step = build_train_step(nwl, create_optimizer(net, **YAML), schedule,
                            preprocess=pp, amp_level="O2")
    loss = step(torch.from_numpy(image), torch.from_numpy(kpts))
    assert loss.dtype == torch.float32
    nwl_j, pp_j = _jax_side(jnp.bfloat16)
    jax_grads = jax.jit(lambda p, s, i, k: jax_accum(nwl_j, p, s, (i, k), preprocess=pp_j))
    loss_j, stats_j, g = jax_grads(variables["params"], variables["batch_stats"],
                                   jnp.asarray(image), jnp.asarray(kpts))
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j, np.float32), rtol=2e-3)
    with torch.no_grad():
        f32_loss = _port_side(variables)[1](*pp(torch.from_numpy(image), torch.from_numpy(kpts)))
    assert abs(float(f32_loss) - float(loss)) > 1e-4 * float(f32_loss)

    want_g = _params_sd(g, variables["batch_stats"])
    cos = [float(torch.nn.functional.cosine_similarity(p.grad.flatten(), want_g[n].flatten(),
                                                       dim=0))
           for n, p in net.named_parameters()]
    assert min(cos) >= 0.6 and np.median(cos) >= 0.9, (min(cos), np.median(cos))
    got = net.state_dict()
    for name, v in _running_stats(_params_sd(variables["params"], stats_j)).items():
        assert float((got[name] - v).abs().max()) <= 5e-2 * float(v.abs().max()), name
