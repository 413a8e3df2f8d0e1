"""ViTPose training in the port against the JAX package: layer decay, the step, resume, the entry.

- ``layer_decay_scales`` per parameter equal the JAX package's per flax leaf,
  exactly; each optimizer group keeps its scale as ``lr_scale``;
- torch AdamW at a group rate ``lr * s`` equals optax's adamw followed by a
  scale ``s`` of the whole update (weight decay included), in float64;
- three steps of a tiny ViT + deconv head with adamw, ``layer_decay`` 0.75,
  ``filter_bias_and_bn`` and the warmup multi-step schedule, the port's step
  against the JAX package's, both in float64 (the JAX ViT's float32
  LayerNorms and loss read as float64), at one microbatch and at 4 (the
  ViT-H recipe's ``grad_accum_steps``): losses, every step's gradients and
  the parameters within 1e-6 of each tensor's largest entry;
- a JAX TrainState saved with layer decay (its adam state one level deeper)
  restores into the port: weights, moments and step, bit for bit;
- ``layer_decay`` on a CNN, or outside (0, 1], raises as in JAX;
- every configs/vitpose recipe passes the train entry's checks and builds
  its net, its optimizer (layer decay for ViT-L and ViT-H) and its decoder;
  the eval and serving entries parse it, ``parallel_mode`` included;
- vitpose_h_tpu.yaml through ``tools/train.train`` on tiny COCO (fsdp on one
  device, 4 microbatches, layer decay), with a test-registered tiny ViT
  loaded from a backbone file at another grid: two steps, then its last
  checkpoint through ``tools/eval.evaluate`` (the callback's stats) and
  ``tools/serve.build_service``.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from flax.core import unfreeze

import mindpose_tpu.models.backbones.vit as jax_vit_module
from mindpose_tpu.models.backbones.vit import ViT as JaxViT
from mindpose_tpu.models.heads.simple_baseline_head import SimpleBaselineHead as JaxHead
from mindpose_tpu.models.loss import mse as jax_mse_module
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.optim.optim_factory import layer_decay_scales as jax_layer_decay_scales
from mindpose_tpu.parallel.train import build_train_step as jax_build_train_step
from mindpose_tpu.parallel.train import create_train_state
from mindpose_tpu.scheduler.schedulers import create_lr_scheduler as jax_create_scheduler
from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.config import Config, parse_args
from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
from mindpose_tpu_torch.models import (
    create_decoder,
    create_loss,
    create_network_from_config,
    create_network_with_loss,
)
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.models.heads import SimpleBaselineHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.optim.optim_factory import layer_decay_scales
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.register import list_components, register
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.tools import serve as port_serve
from mindpose_tpu_torch.tools import train as port_train
from mindpose_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_pretrained_backbone,
    restore_train_state,
)
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import RECORD
from tests.test_torch_bottomup_loss import Float64Numpy
from tests.test_torch_train_step import _adam_gradients, _as, _keypoints
from tests.test_torch_vit import TINY, fill_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(glob.glob(os.path.join(ROOT, "configs", "vitpose", "*.yaml")))
VIT_H_YAML = os.path.join(ROOT, "configs", "vitpose", "vitpose_h_tpu.yaml")
IMAGE_SIZE = (96, 128)  # (W, H): the tiny ViT's 8x6 tokens; two deconvs give 32x24
HEATMAP_SIZE = (24, 32)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
FILTERS = (16, 16)
DECAY = 0.75
# vitpose_b_tpu.yaml's optimizer (adamw, weight decay 0.1 off biases and norms)
OPTIMIZER = dict(name="adamw", weight_decay=0.1, filter_bias_and_bn=True)
F64_RTOL = 1e-6
TINY_VIT = "vit_tiny_test"
ENTRY_TRAIN_IMAGES = 16  # about 32 records: one step of 32 per epoch


def _schedule_kwargs():
    # the recipe's lr and milestones, warmup shortened to 2
    return dict(lr=5e-4, total_epochs=210, steps_per_epoch=1, warmup=2, milestones=[170, 200])


def _jax_net(dtype=jnp.float32):
    return JaxNet(backbone=JaxViT(dtype=dtype, **TINY),
                  head=JaxHead(num_deconv_layers=2, num_deconv_filters=FILTERS,
                               num_deconv_kernels=(4, 4), in_channels=TINY["hidden_dim"],
                               dtype=dtype))


def _port_net(variables=None):
    net = Net(ViT(image_size=IMAGE_SIZE, **TINY),
              SimpleBaselineHead(num_deconv_layers=2, num_deconv_filters=FILTERS,
                                 num_deconv_kernels=(4, 4), in_channels=TINY["hidden_dim"]))
    if variables is not None:
        net.load_state_dict(convert_net_variables(variables, net), strict=True)
    return net


@pytest.fixture(scope="module")
def variables():
    net = _jax_net()
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)),
                                             train=False))
    return fill_variables(shapes, np.random.RandomState(20))


def _full_like(scales, params):
    return jax.tree.map(lambda s, p: np.full(p.shape, s), scales, params)


def test_layer_decay_scales_equal_jax(variables):
    want = convert_net_variables({"params": _full_like(
        jax_layer_decay_scales(variables["params"], DECAY), variables["params"]),
        "batch_stats": variables["batch_stats"]}, _port_net())
    net = _port_net(variables)
    scales = layer_decay_scales(net, DECAY)
    depth = TINY["depth"]
    assert scales["backbone.pos_embed"] == DECAY ** (depth + 1)
    assert scales["backbone.blocks.0.attn.qkv.weight"] == DECAY ** depth
    assert scales["backbone.norm.weight"] == scales["head.final_layer.bias"] == 1.0
    for name, s in scales.items():
        assert torch.all(want[name] == s), name
    optimizer = create_optimizer(net, learning_rate=1e-3, layer_decay=DECAY, **OPTIMIZER)
    for group in optimizer.param_groups:
        assert group["lr"] == 1e-3 * group["lr_scale"]
        for p in group["params"]:
            name = next(n for n, q in net.named_parameters() if q is p)
            assert group["lr_scale"] == scales[name], name
    # (decays, scale) pairs: depth + 2 scales, and both decay settings at most
    assert depth + 2 <= len(optimizer.param_groups) <= 2 * (depth + 2)


def test_group_rate_equals_optax_scaled_update():
    """optax scales the whole adamw update after the optimizer, decay
    included; torch's group rate multiplies the step and the decoupled decay,
    so the two agree (float64, 5 steps, two scales)."""
    rng = np.random.RandomState(21)
    p0 = rng.standard_normal((2, 7))
    grads = rng.standard_normal((5, 2, 7))
    scales = np.array([[1.0], [DECAY ** 3]])
    with jax.enable_x64(True):
        tx = optax.chain(optax.adamw(1e-2, weight_decay=0.1),
                         optax.GradientTransformation(
                             lambda p: optax.EmptyState(),
                             lambda u, s, p=None: (u * scales, s)))
        params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            updates, state = tx.update(jnp.asarray(g), state, params)
            params = optax.apply_updates(params, updates)
        want = np.asarray(params)
    rows = [torch.nn.Parameter(torch.from_numpy(p0[i].copy())) for i in range(2)]
    opt = torch.optim.AdamW([{"params": [rows[i]], "lr": 1e-2 * float(scales[i, 0])}
                             for i in range(2)], lr=1e-2, weight_decay=0.1)
    for g in grads:
        for i in range(2):
            rows[i].grad = torch.from_numpy(g[i].copy())
        opt.step()
    got = np.stack([r.detach().numpy() for r in rows])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert np.abs(want - p0).max() > 1e-3


@pytest.mark.parametrize("accum_steps", [1, 4])
def test_three_steps_match_jax_float64(variables, monkeypatch, accum_steps):
    """The recipe's adamw with layer decay 0.75 and the warmup multi-step
    schedule (warmup 2) for 3 steps on one batch of 8, the port's step and
    the JAX package's both in float64, on the same crops, targets and joint
    weights (the port's preprocess, cast to float64)."""
    rng = np.random.RandomState(22)
    image = rng.randint(0, 256, (8, IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.uint8)
    kpts = _keypoints(rng, 8, w=float(IMAGE_SIZE[0]), h=float(IMAGE_SIZE[1]))
    pp = build_topdown_preprocess(IMAGE_SIZE, HEATMAP_SIZE, MEAN, STD, sigma=2.0)
    batch = tuple(t.double() for t in pp(torch.from_numpy(image), torch.from_numpy(kpts)))
    assert batch[1].abs().max() > 0.5  # targets with peaks

    net = _port_net(variables).double()
    nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    schedule = create_lr_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
    step = build_train_step(nwl, create_optimizer(net, layer_decay=DECAY, **OPTIMIZER), schedule,
                            accum_steps=accum_steps)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}

    def close(got, want, name):
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= F64_RTOL * scale, name

    monkeypatch.setattr(jax_mse_module, "jnp", Float64Numpy())
    monkeypatch.setattr(jax_vit_module, "jnp", Float64Numpy())
    with jax.enable_x64(True):
        jax_net = _jax_net(jnp.float64)
        nwl_j = jax_create_nwl(jax_net, jax_create_loss("joint_mse", use_target_weight=True),
                               has_extra_inputs=True)
        schedule_j = jax_create_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
        variables64 = {"params": _as(variables["params"], jnp.float64),
                       "batch_stats": _as(variables["batch_stats"], jnp.float64)}
        tx = jax_create_optimizer(variables64["params"], learning_rate=schedule_j,
                                  layer_decay=DECAY, **OPTIMIZER)
        state = create_train_state(variables64, tx)
        step_j = jax_build_train_step(nwl_j, tx, donate=False, accum_steps=accum_steps)
        batch_j = (jnp.asarray(batch[0].permute(0, 2, 3, 1).numpy()),
                   jnp.asarray(batch[1].permute(0, 2, 3, 1).numpy()), jnp.asarray(batch[2].numpy()))
        mu = None
        for _ in range(3):
            stats = state.batch_stats
            state, loss_j = step_j(state, *batch_j)
            g, mu = _adam_gradients(state.opt_state, mu)  # the gradient the step took
            want_g = convert_net_variables({"params": g, "batch_stats": stats}, net)
            loss = step(*batch)
            np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=F64_RTOL)
            for name, p in net.named_parameters():
                close(p.grad, want_g[name].double(), name)
        want = convert_net_variables({"params": state.params, "batch_stats": state.batch_stats},
                                     net)
    assert step.count == 3
    for name, value in net.state_dict().items():
        if value.is_floating_point():
            close(value, want[name].double(), name)
    for name, v in start.items():
        assert float((want[name].double() - v).abs().max()) > 1e-5, name  # every tensor moved


def test_jax_layer_decay_train_state_restores_into_the_port(variables, tmp_path):
    """adamw with layer decay after 2 updates of random gradients, written by
    the JAX package's save_checkpoint, restored bit for bit."""
    rng = np.random.RandomState(23)
    tx = jax_create_optimizer(variables["params"], learning_rate=1e-3, layer_decay=0.8,
                              **OPTIMIZER)
    state = create_train_state(variables, tx)
    params, opt_state = state.params, state.opt_state
    update = jax.jit(lambda g, o, p: tx.update(g, o, p))
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    state = state.replace(step=jnp.asarray(2, jnp.int32), params=params, opt_state=opt_state)
    path = str(tmp_path / "vit_state.msgpack")
    jax_save_checkpoint(path, state)

    net = _port_net()
    optimizer = create_optimizer(net, learning_rate=1e-3, layer_decay=0.8, **OPTIMIZER)
    assert restore_train_state(path, net, optimizer) == 2
    stats = jax.device_get(state.batch_stats)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
               if hasattr(s, "mu")]
    want = {kind: convert_net_variables({"params": jax.device_get(tree), "batch_stats": stats},
                                        net)
            for kind, tree in (("param", params), ("exp_avg", adam.mu), ("exp_avg_sq", adam.nu))}
    for name, value in net.state_dict().items():
        assert torch.equal(value, want["param"][name]), name
    for name, p in net.named_parameters():
        s = optimizer.state[p]
        assert float(s["step"]) == 2.0, name
        assert torch.equal(s["exp_avg"], want["exp_avg"][name]), name
        assert torch.equal(s["exp_avg_sq"], want["exp_avg_sq"][name]), name


@pytest.mark.parametrize("decay", [1.5, -0.1])
def test_layer_decay_refusals_match_jax(variables, decay):
    with pytest.raises(ValueError, match=r"layer_decay must be in \(0, 1\]") as port_err:
        create_optimizer(_port_net(), learning_rate=1e-3, layer_decay=decay, **OPTIMIZER)
    with pytest.raises(ValueError) as jax_err:
        jax_create_optimizer(variables["params"], learning_rate=1e-3, layer_decay=decay,
                             **OPTIMIZER)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("recipe", RECIPES, ids=os.path.basename)
def test_vitpose_recipe_passes_the_entries(recipe):
    """As parsed: the train entry reads every key and refuses none; the net,
    its optimizer and its decoder build; the eval and serving entries parse
    it (``parallel_mode`` among its keys)."""
    args = port_train.parse_train_args(["--config", recipe])
    port_train.check_config(args)
    with torch.device("meta"):
        net = create_network_from_config(args)
    assert isinstance(net.backbone, ViT) and net.backbone.grid == (16, 12)
    optimizer = create_optimizer(net, name=args.optimizer, learning_rate=args.lr,
                                 weight_decay=args.weight_decay,
                                 filter_bias_and_bn=args.filter_bias_and_bn,
                                 **args.optimizer_setting)
    scales = {g["lr_scale"] for g in optimizer.param_groups}
    if args.optimizer_setting.get("layer_decay"):
        assert len(scales) == net.backbone.depth + 2 and min(scales) < 0.01
    else:
        assert scales == {1.0}
    decoder = create_decoder(args.decoder_name, **args.decoder_setting)
    assert decoder is not None and args.decoder_setting == {"shift_coordinate": False}
    for parse in (parse_args, port_serve.parse_serve_args):  # the eval CLI's, the server's
        parsed = parse(["--config", recipe, "--ckpt", "unused.ckpt"])
        for key in ("backbone_name", "head_setting", "decoder_setting", "parallel_mode"):
            assert getattr(parsed, key, None) == getattr(args, key, None), key


def _register_tiny_vit():
    if TINY_VIT in list_components("backbone"):
        return

    def vit_tiny_test(pretrained=False, ckpt_url="", in_channels=3, **kwargs):
        return ViT(image_size=kwargs.get("image_size", IMAGE_SIZE), in_channels=in_channels,
                   **TINY)

    register("backbone", extra_name=TINY_VIT)(vit_tiny_test)


def test_vitpose_h_recipe_trains_from_a_backbone_file(tmp_path, monkeypatch):
    """vitpose_h_tpu.yaml as parsed (fsdp on one device, batch 32 in 4
    microbatches, adamw with layer decay 0.8), with the tiny ViT, the
    fixture's crop size and a narrow head, on tiny COCO: the backbone comes
    from a flax file at a 14x14 grid (resized), before the optimizer is
    built; two steps; the last checkpoint through the eval entry gives the
    callback's stats; the serving entry answers a box."""
    _register_tiny_vit()
    root = str(tmp_path)
    train = tiny_coco.write_split(os.path.join(root, "train"), ENTRY_TRAIN_IMAGES,
                                  tiny_coco.TRAIN_SEED)
    val_root, val_label = tiny_coco.write_val(os.path.join(root, "val"))
    shapes = jax.eval_shape(lambda: JaxViT(**TINY).init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 224, 224, 3)), train=False))
    backbone_file = os.path.join(root, "vit_tiny_224.msgpack")
    with open(backbone_file, "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"params": fill_variables(unfreeze(shapes), np.random.RandomState(24))["params"]}))
    options = dict(train_root=train[0], train_label=train[1], val_root=val_root,
                   val_label=val_label, backbone_name=TINY_VIT,
                   dataset_setting=RECORD["config"]["dataset_setting"],
                   head_setting={"num_deconv_layers": 2, "num_deconv_filters": list(FILTERS),
                                 "num_deconv_kernels": [4, 4]},
                   backbone_pretrained=True, backbone_ckpt_url="file://" + backbone_file,
                   num_epochs=2, warmup=2, val_interval=2, amp_level="O0",
                   num_parallel_workers=1, ckpt_save_dir=os.path.join(root, "ckpt"))
    args = port_train.parse_train_args(
        ["--config", VIT_H_YAML, "--device", "cpu", "--cfg-options",
         *(f"{k}={v}" if isinstance(v, str) else f"{k}={v!r}" for k, v in options.items())])
    assert args.parallel_mode == "fsdp" and args.grad_accum_steps == 4

    loaded, groups = {}, []
    real_load, real_optimizer = port_train.load_pretrained_backbone, port_train.create_optimizer

    def load(path, net):
        n = real_load(path, net)
        loaded.update({k: v.clone() for k, v in net.backbone.state_dict().items()})
        assert not groups  # before the optimizer is built
        return n

    def optimizer(net, **kw):
        opt = real_optimizer(net, **kw)
        groups.extend(opt.param_groups)
        return opt

    monkeypatch.setattr(port_train, "load_pretrained_backbone", load)
    monkeypatch.setattr(port_train, "create_optimizer", optimizer)
    result = port_train.train(args)
    assert result["pretrained_tensors"] == len(jax.tree.leaves(shapes["params"]))
    fresh = create_network_from_config(args)
    load_pretrained_backbone(backbone_file, fresh)
    for name, value in fresh.backbone.state_dict().items():
        assert torch.equal(loaded[name], value), name
    assert len({g["lr_scale"] for g in groups}) == TINY["depth"] + 2
    epochs = result["epochs"]
    assert [e["steps"] for e in epochs] == [1, 1] and result["step"] == 2
    assert all(np.isfinite(e["loss"]) for e in epochs)
    stats = epochs[-1]["metrics"]
    assert stats and np.isfinite(float(stats["AP"]))

    last = os.path.join(root, "ckpt", "vitpose_h_tpu_last.ckpt")
    assert load_checkpoint(last)["step"] == 2
    got = port_eval.evaluate(Config(**dict(vars(args), ckpt=last,
                                           result_path=os.path.join(root, "result.json"))),
                             device=torch.device("cpu"))
    for k, v in stats.items():
        assert abs(float(got[k]) - float(v)) <= 1e-6, k
    serve_args = port_serve.parse_serve_args(["--config", VIT_H_YAML, "--ckpt", last,
                                              "--device", "cpu"])
    for k in ("backbone_name", "dataset_setting", "head_setting"):
        setattr(serve_args, k, getattr(args, k))
    service = port_serve.build_service(serve_args, batch_size=8, device=torch.device("cpu"))
    try:
        image = np.full((160, 224, 3), 127, np.uint8)
        preds = service.predictor(image, np.array([[40.0, 20.0, 60.0, 120.0]], np.float32))
    finally:
        service.close()
    assert preds.shape == (1, 17, 3) and np.isfinite(preds).all()
