"""The port's bottom-up training against the JAX package's, on the CPU.

The bottom-up fixture's reduced HigherHRNet (tests/fixtures: the fixture
HRNet, 8 channels per branch, with a ``higher_hrnet_head`` of 16 deconv
filters; 128x128 input, levels 32x32 and 64x64) trained as
configs/higher_hrnet/higher_hrnet_w32_tpu.yaml says (adam, the
``warmup_cosine_decay`` schedule, ``ae_multi_loss`` with its extra
inputs), overridden only where the reduced net and a short run need it.
One jitted JAX step, in float64, serves every comparison, so JAX compiles
it once. It runs the head's plain form: the default ``s2d_refine`` form
(the same variables) takes its train-mode BatchNorm statistics in float32
even in float64.

- The train step: 3 steps from the fixture's weights on one loader batch,
  the port and JAX both in float64, their losses too (the JAX losses'
  float32 casts lifted, as in tests/test_torch_bottomup_loss.py; the port
  takes a float64 net's losses in float64): loss vectors within rtol
  ``F64_RTOL``; parameters, BatchNorm statistics and the adam moments
  within ``F64_RTOL`` of each tensor's largest entry.
- The train entry, at O0 (float32), resumed from a JAX adam TrainState
  (the fixture's weights after 2 steps, saved in float32), for 2 epochs of
  2 steps with the callback evaluating after each: each epoch's mean loss
  within rtol 1e-4 of the JAX loop's (float64, on the same loader
  batches; measured 7.7e-8 and 1.9e-7), at JAX's step count and learning
  rate. The resumed adam moments are the JAX state's, the head's
  transposed-conv ones flipped with its kernel; one more step from them
  gives JAX's next step within 1e-4 of each tensor's largest entry
  (measured 3.9e-5 at worst).
- The callback evaluated the net each train step left in train mode, in
  eval mode (the net's mode at each forward); the last checkpoint holds the
  trained net bit for bit, and through the eval entry gives the callback's
  last persons bit for bit and its stats (1e-4), with AP above 0.1.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.models import create_loss as jax_create_loss
from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.models import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.loss import ae as jax_ae_module
from mindpose_tpu.models.loss import mse as jax_mse_module
from mindpose_tpu.optim import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel import build_train_step as jax_build_train_step
from mindpose_tpu.parallel import create_train_state
from mindpose_tpu.scheduler import create_lr_scheduler as jax_create_lr_scheduler
from mindpose_tpu.utils.checkpoint import load_variables as jax_load_variables
from mindpose_tpu.utils.checkpoint import restore_train_state as jax_restore_train_state
from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.models import create_loss, create_network, create_network_with_loss
from mindpose_tpu_torch.models import convert
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.tools import train as port_train
from mindpose_tpu_torch.utils.checkpoint import load_checkpoint, restore_train_state
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import (BOTTOMUP_CKPT, BOTTOMUP_RECORD,
                                        compare_callback_with_eval_entry, recording_entry,
                                        register_port_backbone)
from tests.test_torch_bottomup_loss import Float64Numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "higher_hrnet", "higher_hrnet_w32_tpu.yaml")
with open(RECIPE) as f:
    RECIPE_CFG = yaml.safe_load(f)
CONFIG_NAME = "higher_hrnet_w32_tpu"
CFG = BOTTOMUP_RECORD["config"]
TRAIN_IMAGES = 8  # 8 records at batch 4: 2 steps per epoch
BATCH = 4
SEED = 0
PRE_STEPS = 2  # adam steps in the JAX TrainState the entry resumes from
LOSS_RTOL, STATS_ATOL, TENSOR_RTOL = 1e-4, 1e-4, 1e-4
# float64 on both sides, the same arithmetic in other orders (measured: the
# loss vectors 1.1e-14 apart, tensors at most 2.6e-13 of their largest entry)
F64_RTOL = 1e-9


def _overrides(root, data, **extra):
    """--cfg-options of the recipe for the fixture's reduced net on tiny_coco."""
    (train_root, train_label), (val_root, val_label) = data
    options = dict(
        train_root=train_root, train_label=train_label, val_root=val_root,
        val_label=val_label, backbone_name=CFG["backbone_name"],
        backbone_setting={}, dataset_setting=CFG["dataset_setting"],
        head_setting=CFG["head_setting"], decoder_setting=CFG["decoder_setting"],
        loss_setting=dict(RECIPE_CFG["loss_setting"],
                          stage_sizes=CFG["dataset_setting"]["heatmap_sizes"]),
        batch_size=BATCH, num_epochs=2, warmup=1, lr_scheduler_setting={"min_lr": 1e-4},
        val_interval=1, amp_level="O0", num_parallel_workers=1,
        ckpt_save_dir=os.path.join(root, "ckpt"))
    options.update(extra)
    return [f"{k}={v!r}" if not isinstance(v, str) else f"{k}={v}" for k, v in options.items()]


def _args(root, data, *flags, **extra):
    return port_train.parse_train_args(["--config", RECIPE, "--device", "cpu", "--seed",
                                        str(SEED), *flags, "--cfg-options",
                                        *_overrides(root, data, **extra)])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_coco"))
    fixture.register_jax_backbone()
    register_port_backbone()
    return (tiny_coco.write_split(os.path.join(root, "train"), TRAIN_IMAGES,
                                  tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))


@pytest.fixture(scope="module")
def float64_jax():
    """JAX in float64, its losses too, for the module."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_ae_module, "jnp", Float64Numpy())
        mp.setattr(jax_mse_module, "jnp", Float64Numpy())
        yield


def _floats_as(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype)
                        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


COLUMNS = ("image", "target", "mask", "tag_ind")


def _jax_loader(args, seed):
    ds = jax_create_dataset(args.train_root, args.train_label,
                            dataset_format=args.dataset_format, is_train=True,
                            num_workers=args.num_parallel_workers, config=args.dataset_setting)
    return jax_create_pipeline(
        ds, transforms=args.train_transforms, method=args.pipeline_method,
        batch_size=args.batch_size, is_train=True, normalize_mean=args.normalize_mean,
        normalize_std=args.normalize_std, num_workers=args.num_parallel_workers,
        config=args.dataset_setting, seed=seed)


@pytest.fixture(scope="module")
def jax_run(data, float64_jax, tmp_path_factory):
    """JAX: the TrainState the entry resumes from, and the JAX loop's epochs.

    ``tools/train.py:train``'s calls in its order, on the config the port
    entry parses, in float64, without evaluation (the comparison is the
    loss); the state is saved in float32, as a float32 run writes it.
    """
    root = str(tmp_path_factory.mktemp("jax"))
    args = _args(root, data)
    # the head's plain form: its default s2d form takes the train-mode
    # BatchNorm statistics in float32 (mindpose_tpu/models/backbones/s2d.py:152),
    # 2e-7 off in float64; both forms have the same variables
    net = jax_create_network(args.backbone_name, args.head_name, num_joints=args.num_joints,
                             backbone_args=args.backbone_setting,
                             head_args=dict(args.head_setting, s2d_refine=False),
                             dtype=jnp.float64)
    w, h = args.dataset_setting["image_size"]
    variables = _floats_as(net.init(jax.random.PRNGKey(SEED), jnp.zeros((1, h, w, 3)),
                                    train=False), jnp.float64)
    nwl = jax_create_nwl(net, jax_create_loss(args.loss, **args.loss_setting),
                         has_extra_inputs=args.loss_with_extra_input)
    np.random.seed(SEED + 100)
    pre_batches = list(_jax_loader(args, SEED + 100))
    np.random.seed(SEED)
    loader = _jax_loader(args, SEED)
    schedule = jax_create_lr_scheduler(
        args.scheduler, lr=args.lr, total_epochs=args.num_epochs,
        steps_per_epoch=len(loader), warmup=args.warmup, **args.lr_scheduler_setting)
    tx = jax_create_optimizer(variables["params"], name=args.optimizer, learning_rate=schedule,
                              weight_decay=args.weight_decay,
                              filter_bias_and_bn=args.filter_bias_and_bn)
    step_fn = jax_build_train_step(nwl, tx, mesh=None, donate=False)
    fixture_vars = _floats_as(jax_load_variables(BOTTOMUP_CKPT, variables), jnp.float64)

    def fresh():
        return create_train_state(fixture_vars, tx)

    state = fresh()
    for batch in pre_batches[:PRE_STEPS]:
        state, _ = step_fn(state, *(jnp.asarray(batch[c]) for c in COLUMNS))
    ckpt_in = os.path.join(root, "resume.msgpack")
    jax_save_checkpoint(ckpt_in, _floats_as(state, jnp.float32))

    def restore():
        return _floats_as(jax_restore_train_state(ckpt_in, fresh()), jnp.float64)

    state = restore()
    epochs = []
    for _ in range(args.num_epochs):
        losses = []
        for batch in loader:
            state, loss_vec = step_fn(state, *(jnp.asarray(batch[c]) for c in COLUMNS))
            losses.append(float(np.asarray(loss_vec).sum()))
        epochs.append({"loss": float(np.mean(losses)),
                       "lr": float(schedule(int(state.step))), "steps": len(losses)})
    return {"ckpt": ckpt_in, "epochs": epochs, "step": int(state.step), "step_fn": step_fn,
            "restore": restore, "fresh": fresh, "args": args}


@pytest.fixture(scope="module")
def port_run(data, jax_run, tmp_path_factory):
    """The port's entry resumed from the JAX state, with what its callback
    evaluated (``recording_entry``)."""
    root = str(tmp_path_factory.mktemp("port"))
    with recording_entry(port_train) as seen:
        result = port_train.train(_args(root, data, "--ckpt", jax_run["ckpt"]))
    return root, result, seen


def _port_net(args):
    return create_network(args.backbone_name, args.head_name, num_joints=args.num_joints,
                          head_args=args.head_setting)


def _port_batch(args):
    np.random.seed(SEED)
    ds = create_dataset(args.train_root, args.train_label, dataset_format=args.dataset_format,
                        is_train=True, config=args.dataset_setting)
    batch = next(iter(create_pipeline(ds, args.train_transforms, method="bottomup",
                                      batch_size=args.batch_size, is_train=True,
                                      config=args.dataset_setting, num_workers=1)))
    return [batch[c] for c in COLUMNS]


def _step_inputs(image, target, mask, tag_ind, dtype=torch.float32):
    """The train entry's upload: NHWC -> NCHW, [N, S, H, W, K] -> [N, S, K, H, W]."""
    return (torch.from_numpy(image).permute(0, 3, 1, 2).contiguous().to(dtype),
            torch.from_numpy(target).permute(0, 1, 4, 2, 3).contiguous().to(dtype),
            torch.from_numpy(mask), torch.from_numpy(tag_ind))


def _adam(state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return adam


def _as_port(state, net):
    """params, BatchNorm statistics and adam moments of a JAX state, in the
    port's names, converted at float64 (the converter's own tensors are float32)."""
    stats = jax.device_get(state.batch_stats)
    adam = _adam(state)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "_tensor", lambda v: torch.from_numpy(np.array(v, np.float64)))
        return {"param": convert_net_variables({"params": jax.device_get(state.params),
                                                "batch_stats": stats}, net),
                "exp_avg": convert_net_variables({"params": jax.device_get(adam.mu),
                                                  "batch_stats": stats}, net),
                "exp_avg_sq": convert_net_variables({"params": jax.device_get(adam.nu),
                                                     "batch_stats": stats}, net)}


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1e-30)


def test_train_step_matches_jax_in_float64(jax_run):
    """3 steps of the reduced net from the fixture's weights on one batch: the
    schedule gives step 0 lr 0 and steps 1, 2 lr > 0."""
    args = jax_run["args"]
    batch = _port_batch(args)
    assert batch[2].min() == 0 and batch[3][..., 1].sum() > 0  # masked pixels, tags
    net = _port_net(args)
    net.load_state_dict(convert_net_variables(jax_load_variables(BOTTOMUP_CKPT), net),
                        strict=True)
    net.double()
    nwl = create_network_with_loss(net, create_loss(args.loss, **args.loss_setting),
                                   has_extra_inputs=True)
    optimizer = create_optimizer(net, args.optimizer, learning_rate=args.lr,
                                 weight_decay=args.weight_decay,
                                 filter_bias_and_bn=args.filter_bias_and_bn)
    schedule = create_lr_scheduler(args.scheduler, lr=args.lr, total_epochs=args.num_epochs,
                                   steps_per_epoch=2, warmup=args.warmup,
                                   **args.lr_scheduler_setting)
    step = build_train_step(nwl, optimizer, schedule)
    inputs = _step_inputs(*batch, dtype=torch.float64)
    start = {k: v.detach().clone() for k, v in net.named_parameters()}

    state = jax_run["fresh"]()
    batch_j = [jnp.asarray(a) for a in batch]
    for i in range(3):
        state, loss_j = jax_run["step_fn"](state, *batch_j)
        loss = step(*inputs)
        assert loss.dtype == torch.float64 and loss.shape == (3,)
        np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=F64_RTOL)
    assert np.asarray(loss_j).min() > 0 and schedule(1) > 0 and schedule(2) > 0
    want = _as_port(state, net)
    for name, value in net.state_dict().items():
        if value.is_floating_point():
            assert _rel_err(value, want["param"][name]) <= F64_RTOL, name
    for name, p in net.named_parameters():
        s = optimizer.state[p]
        for kind in ("exp_avg", "exp_avg_sq"):
            assert _rel_err(s[kind], want[kind][name]) <= F64_RTOL, (kind, name)
        assert float((want["param"][name].double() - start[name]).abs().max()) > 0, name


def test_entry_matches_the_jax_loop(jax_run, port_run):
    _, got, _ = port_run
    want = jax_run["epochs"]
    assert got["start_step"] == PRE_STEPS
    assert got["step"] == jax_run["step"] == PRE_STEPS + 2 * 2
    assert len(got["epochs"]) == len(want) == 2
    for g, w in zip(got["epochs"], want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7) and g["lr"] > 0
        assert g["steps"] == w["steps"] == 2 and g["images"] == 2 * BATCH
        assert 0 <= float(g["metrics"]["AP"]) <= 1


def test_resumed_adam_state_carries_the_moments_and_takes_jax_s_next_step(data, jax_run,
                                                                          tmp_path):
    args = jax_run["args"]
    net = _port_net(args)
    optimizer = create_optimizer(net, args.optimizer, learning_rate=args.lr,
                                 weight_decay=args.weight_decay,
                                 filter_bias_and_bn=args.filter_bias_and_bn)
    assert restore_train_state(jax_run["ckpt"], net, optimizer) == PRE_STEPS
    restored = jax_run["restore"]()
    # the head's transposed conv: flax [kh, kw, I, O], unflipped; torch [I, O, kh, kw], flipped
    adam = _adam(restored)
    deconv = net.head.deconv_layers[0][0].weight
    assert isinstance(net.head.deconv_layers[0][0], torch.nn.ConvTranspose2d)
    for kind, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        kernel = np.asarray(tree["head"]["ConvTranspose_0"]["kernel"], np.float32)
        want = np.ascontiguousarray(np.flip(kernel, (0, 1)).transpose(2, 3, 0, 1))
        np.testing.assert_array_equal(optimizer.state[deconv][kind].numpy(), want)
        assert np.abs(want).max() > 0 and not np.array_equal(
            optimizer.state[deconv][kind].numpy(),
            np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))

    nwl = create_network_with_loss(net, create_loss(args.loss, **args.loss_setting),
                                   has_extra_inputs=True)
    schedule = create_lr_scheduler(args.scheduler, lr=args.lr, total_epochs=args.num_epochs,
                                   steps_per_epoch=2, warmup=args.warmup,
                                   **args.lr_scheduler_setting)
    step = build_train_step(nwl, optimizer, schedule, start_step=PRE_STEPS)
    batch = _port_batch(args)
    loss = step(*_step_inputs(*batch))
    assert step.count == PRE_STEPS + 1 and optimizer.param_groups[0]["lr"] == schedule(
        PRE_STEPS) > 0
    state, want_loss = jax_run["step_fn"](restored, *(jnp.asarray(a) for a in batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=LOSS_RTOL)
    want = _as_port(state, net)
    for name, p in net.named_parameters():
        s = optimizer.state[p]
        assert float(s["step"]) == step.count == int(_adam(state).count)
        for kind, value in (("param", p.detach()), ("exp_avg", s["exp_avg"]),
                            ("exp_avg_sq", s["exp_avg_sq"])):
            assert _rel_err(value, want[kind][name]) <= TENSOR_RTOL, (kind, name)


def test_last_checkpoint_through_the_eval_entry_gives_the_callback_stats(data, port_run):
    """The callback evaluated the net each train step left in train mode, in
    eval mode; its last checkpoint holds that net, and through the eval entry
    gives the callback's persons and stats, which are not all zero."""
    root, got, trained = port_run
    ckpt_dir = os.path.join(root, "ckpt")
    last = os.path.join(ckpt_dir, f"{CONFIG_NAME}_last.ckpt")
    ckpt = load_checkpoint(last)
    assert ckpt["step"] == got["step"]
    with open(os.path.join(ckpt_dir, "summary", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [1, 2]
    args = _args(root, data)
    args.ckpt = last
    args.result_path = os.path.join(root, "result.json")
    with recording_entry(port_eval) as evaluated:
        stats = port_eval.evaluate(args, device="cpu")
    same = compare_callback_with_eval_entry(trained, evaluated, ckpt)
    assert same["evaluations"] == 2 and same["persons"] > 0
    assert same["pred_err"] == 0 and same["score_err"] == 0, same
    assert float(stats["AP"]) > 0.1
    for name in fixture.STAT_NAMES:
        assert abs(float(stats[name]) - records[-1][f"val/{name}"]) <= STATS_ATOL, name
        assert float(stats[name]) == float(got["epochs"][-1]["metrics"][name])
