"""The port's training entry against the JAX package's training loop, on the CPU.

Both resume from one JAX TrainState: the fixture's trained reduced HRNet
(tests/fixtures, 8 channels per branch) after 2 adamw steps of
hrnet_w32_tpu.yaml's optimizer and schedule, saved as flax msgpack. Then
each trains 2 epochs of tiny_coco's train split with the recipe's
augmentations, one loader worker and one seed, with EMA and
``val_while_train`` every epoch: the port through
``mindpose_tpu_torch.tools.train.train`` at O0 (float32), JAX through the
parts that ``tools/train.py:train`` calls, in its order (one jitted step
serves the state's 2 steps and the loop, so JAX compiles it once). The
loader gives both the same bytes (tests/test_torch_train_loader.py).

The JAX side runs in float64, as tests/test_torch_train_step.py's whole
steps do: there JAX's float32 gradient on the CPU is off its float64 one by
up to 0.14 of a tensor's largest entry, while the port's float32 gradient
agrees with float64 to 5e-6 of it. Here, after the 8 steps, a float32 JAX
run's parameters were up to 4e-3 of a tensor's largest entry off the
port's, and the float64 run's 1e-4. Against the float64 reference, with
the port in float32:

- each epoch's mean loss agrees within rtol 1e-4 and the last evaluation's
  10 COCO stats within 1e-3 (an AP above 0.5);
- from the resumed state, one more step on one loader batch gives JAX's
  loss, parameters and Adam moments within 1e-4 of each tensor's largest
  entry (measured at worst 5e-6 and 5e-5), at JAX's step count and
  learning rate;
- the callback writes the best and last checkpoints, their ``.ema`` files
  and one ``metrics.jsonl`` line per epoch (``async_checkpoint``: all
  written by the time ``train`` returns); the CLI trains and its last
  checkpoint gives the callback's stats through the eval entry; a failing
  step leaves a crash checkpoint at the step reached; each config key the
  entry does not support raises.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.callbacks import EvalCallback as JaxEvalCallback
from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.engine import create_evaluator as jax_create_evaluator
from mindpose_tpu.engine import create_inferencer as jax_create_inferencer
from mindpose_tpu.models import create_decoder as jax_create_decoder
from mindpose_tpu.models import create_eval_network as jax_create_eval_network
from mindpose_tpu.models import create_loss as jax_create_loss
from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.models import create_network_with_loss as jax_create_nwl
from mindpose_tpu.optim import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel import build_ema_update as jax_build_ema_update
from mindpose_tpu.parallel import build_train_step as jax_build_train_step
from mindpose_tpu.parallel import create_train_state
from mindpose_tpu.scheduler import create_lr_scheduler as jax_create_lr_scheduler
from mindpose_tpu.utils.checkpoint import load_variables as jax_load_variables
from mindpose_tpu.utils.checkpoint import restore_train_state as jax_restore_train_state
from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.models import create_loss, create_network, create_network_with_loss
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.tools import train as port_train
from mindpose_tpu_torch.utils.checkpoint import load_checkpoint, load_ema, restore_train_state
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import CKPT, RECORD, register_port_backbone

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "hrnet", "hrnet_w32_tpu.yaml")
CONFIG_NAME = "hrnet_w32_tpu"
TRAIN_IMAGES = 32  # 64 records: 4 steps per epoch at batch 16
SEED = 0
LOSS_RTOL, STATS_ATOL, TENSOR_RTOL = 1e-4, 1e-3, 1e-4
PRE_STEPS = 2  # adamw steps in the JAX TrainState both resume from


def _overrides(root, data, **extra):
    """--cfg-options of the recipe for the fixture net on tiny_coco."""
    (train_root, train_label), (val_root, val_label) = data
    cfg = RECORD["config"]
    options = dict(train_root=train_root, train_label=train_label, val_root=val_root,
                   val_label=val_label, backbone_name=cfg["backbone_name"],
                   dataset_setting=cfg["dataset_setting"], batch_size=16, num_epochs=2,
                   warmup=3, val_interval=1, amp_level="O0", num_parallel_workers=1,
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
    return (tiny_coco.write_split(os.path.join(root, "train"), TRAIN_IMAGES, tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))


def _jax_batch(seed):
    w, h = RECORD["config"]["dataset_setting"]["image_size"]
    hw, hh = RECORD["config"]["dataset_setting"]["heatmap_size"]
    rng = np.random.RandomState(seed)
    return (rng.randn(16, h, w, 3).astype(np.float32),
            (rng.uniform(0, 1, (16, hh, hw, 17)) ** 8).astype(np.float32),
            (rng.uniform(0, 1, (16, 17)) < 0.8).astype(np.float32))


def _floats_as(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype)
                        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """JAX: the TrainState both resume from, its path, and the JAX loop's results.

    ``tools/train.py:train``'s calls in its order, on the config the port
    entry parses, in float64 (see the module's docstring), with one jitted
    step shared by the state's first steps, the loop and the one-more-step
    check. The state is saved in float32, as a float32 run writes it.
    """
    root = str(tmp_path_factory.mktemp("jax"))
    args = _args(root, data, ema_decay=0.9)
    seed = args.seed
    with jax.enable_x64(True):
        np.random.seed(seed)
        ds_train = jax_create_dataset(args.train_root, args.train_label,
                                      dataset_format=args.dataset_format, is_train=True,
                                      num_workers=args.num_parallel_workers,
                                      config=args.dataset_setting)
        loader_train = jax_create_pipeline(
            ds_train, transforms=args.train_transforms, method=args.pipeline_method,
            batch_size=args.batch_size, is_train=True, normalize_mean=args.normalize_mean,
            normalize_std=args.normalize_std, num_workers=args.num_parallel_workers,
            config=args.dataset_setting, seed=seed)
        ds_val = jax_create_dataset(args.val_root, args.val_label,
                                    dataset_format=args.dataset_format, is_train=False,
                                    use_gt_bbox_for_val=args.val_use_gt_bbox,
                                    num_workers=args.num_parallel_workers,
                                    config=args.dataset_setting)
        loader_val = jax_create_pipeline(
            ds_val, transforms=args.val_transforms, method=args.pipeline_method,
            batch_size=args.batch_size, is_train=False, normalize_mean=args.normalize_mean,
            normalize_std=args.normalize_std, num_workers=args.num_parallel_workers,
            config=args.dataset_setting)
        net = jax_create_network(args.backbone_name, args.head_name,
                                 num_joints=args.num_joints, backbone_args=args.backbone_setting,
                                 head_args=args.head_setting, dtype=jnp.float64)
        w, h = args.dataset_setting["image_size"]
        variables = _floats_as(net.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3)),
                                        train=False), jnp.float64)
        nwl = jax_create_nwl(net, jax_create_loss(args.loss, **args.loss_setting),
                             has_extra_inputs=args.loss_with_extra_input)
        schedule = jax_create_lr_scheduler(
            args.scheduler, lr=args.lr, total_epochs=args.num_epochs,
            steps_per_epoch=len(loader_train), warmup=args.warmup, **args.lr_scheduler_setting)
        tx = jax_create_optimizer(variables["params"], name=args.optimizer,
                                  learning_rate=schedule, weight_decay=args.weight_decay,
                                  filter_bias_and_bn=args.filter_bias_and_bn)
        step_fn = jax_build_train_step(nwl, tx, mesh=None, donate=False)

        # the TrainState both runs resume from: the fixture's weights, 2 adamw steps
        state = create_train_state(_floats_as(jax_load_variables(CKPT, variables), jnp.float64),
                                   tx)
        for i in range(PRE_STEPS):
            state, _ = step_fn(state, *map(jnp.asarray, _jax_batch(10 + i)))
        ckpt_in = os.path.join(root, "resume.msgpack")
        jax_save_checkpoint(ckpt_in, _floats_as(state, jnp.float32))

        def restore():
            return _floats_as(jax_restore_train_state(ckpt_in, create_train_state(variables, tx)),
                              jnp.float64)

        state = restore()
        ema_params = jax.tree.map(jnp.copy, state.params)
        ema_step = jax_build_ema_update(args.ema_decay)
        eval_net = jax_create_eval_network(net, jax_create_decoder(args.decoder_name,
                                                                   **args.decoder_setting))
        inferencer = jax_create_inferencer(eval_net, name=args.inference_method,
                                           config=args.eval_setting,
                                           dataset_config=args.dataset_setting, mesh=None)
        evaluator = jax_create_evaluator(
            args.val_label, name=args.eval_method, metric=args.eval_metric,
            config=args.eval_setting, dataset_config=args.dataset_setting,
            num_joints=args.num_joints, result_path=os.path.join(root, "result_keypoints.json"))
        callback = JaxEvalCallback(inferencer=inferencer, evaluator=evaluator,
                                   dataset_val=loader_val, interval=args.val_interval,
                                   max_epoch=args.num_epochs,
                                   summary_dir=os.path.join(root, "summary"))
        epochs = []
        for epoch in range(1, args.num_epochs + 1):
            callback.on_epoch_begin(epoch)
            for batch in loader_train:
                state, loss_vec = step_fn(state, *(jnp.asarray(batch[c]) for c in
                                                   ("image", "target", "target_weight")))
                ema_params = ema_step(ema_params, state.params)
                callback.on_step_end(loss_vec)
            lr = float(schedule(int(state.step)))
            metrics = callback.on_epoch_end(epoch, state, lr, ema_params=ema_params)
            epochs.append({"loss": callback.loss_meter.avg, "lr": lr, "metrics": metrics})
    return {"ckpt": ckpt_in, "epochs": epochs, "step": int(state.step), "step_fn": step_fn,
            "restore": restore}


@pytest.fixture(scope="module")
def port_run(data, jax_run, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port"))
    args = _args(root, data, "--ckpt", jax_run["ckpt"], ema_decay=0.9, async_checkpoint=True)
    return root, port_train.train(args)


def _stats(metrics):
    return np.array([float(metrics[k]) for k in fixture.STAT_NAMES])


def test_entry_matches_the_jax_loop(jax_run, port_run):
    _, got = port_run
    want = jax_run["epochs"]
    assert got["start_step"] == PRE_STEPS
    assert got["step"] == jax_run["step"] == PRE_STEPS + 2 * TRAIN_IMAGES * 2 // 16
    assert len(got["epochs"]) == len(want) == 2
    for g, w in zip(got["epochs"], want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7)
        np.testing.assert_allclose(_stats(g["metrics"]), _stats(w["metrics"]), rtol=0,
                                   atol=STATS_ATOL)
        assert g["steps"] == 4 and g["images"] == 64
    assert float(got["epochs"][-1]["metrics"]["AP"]) > fixture.TARGET_AP


def test_callback_files(port_run):
    root, got = port_run
    ckpt_dir = os.path.join(root, "ckpt")
    names = sorted(os.listdir(ckpt_dir))
    assert names == sorted([f"{CONFIG_NAME}_best.ckpt", f"{CONFIG_NAME}_best.ckpt.ema",
                            f"{CONFIG_NAME}_last.ckpt", f"{CONFIG_NAME}_last.ckpt.ema", "summary"])
    last = load_checkpoint(os.path.join(ckpt_dir, f"{CONFIG_NAME}_last.ckpt"))
    assert last["step"] == got["step"] and last["optimizer"]["state"]
    ema = load_ema(os.path.join(ckpt_dir, f"{CONFIG_NAME}_last.ckpt.ema"))
    net_params = [k for k, v in last["net"].items() if v.is_floating_point()
                  and not k.endswith(("running_mean", "running_var"))]
    assert sorted(ema) == sorted(net_params)
    assert any(not torch.equal(ema[k], last["net"][k]) for k in ema)
    with open(os.path.join(ckpt_dir, "summary", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [1, 2]
    for r, epoch in zip(records, got["epochs"]):
        assert r["train/loss"] == epoch["loss"] and r["val/AP"] == float(epoch["metrics"]["AP"])
    best = max(records, key=lambda r: r["val/AP"])
    assert load_checkpoint(os.path.join(ckpt_dir, f"{CONFIG_NAME}_best.ckpt"))["step"] == (
        PRE_STEPS + 4 * best["epoch"])


def test_resumed_adamw_state_takes_jax_s_next_step(data, jax_run, tmp_path):
    args = _args(str(tmp_path), data)
    net = create_network(args.backbone_name, args.head_name, num_joints=args.num_joints)
    optimizer = create_optimizer(net, args.optimizer, learning_rate=args.lr,
                                 weight_decay=args.weight_decay,
                                 filter_bias_and_bn=args.filter_bias_and_bn)
    schedule = create_lr_scheduler(args.scheduler, lr=args.lr, total_epochs=args.num_epochs,
                                   steps_per_epoch=4, warmup=args.warmup,
                                   **args.lr_scheduler_setting)
    start = restore_train_state(jax_run["ckpt"], net, optimizer)
    assert start == PRE_STEPS
    nwl = create_network_with_loss(net, create_loss(args.loss, **args.loss_setting),
                                   has_extra_inputs=True)
    step = build_train_step(nwl, optimizer, schedule, start_step=start)
    np.random.seed(SEED)
    dataset = create_dataset(args.train_root, args.train_label, is_train=True,
                             config=args.dataset_setting)
    batch = next(iter(create_pipeline(dataset, args.train_transforms, batch_size=16,
                                      is_train=True, config=args.dataset_setting, num_workers=1)))
    image, target, weight = (batch[c] for c in ("image", "target", "target_weight"))
    loss = step(torch.from_numpy(image).permute(0, 3, 1, 2).contiguous(),
                torch.from_numpy(target).permute(0, 3, 1, 2).contiguous(),
                torch.from_numpy(weight))
    assert step.count == PRE_STEPS + 1
    assert optimizer.param_groups[0]["lr"] == schedule(PRE_STEPS) > 0

    with jax.enable_x64(True):
        state, want_loss = jax_run["step_fn"](jax_run["restore"](),
                                              *map(jnp.asarray, (image, target, weight)))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=LOSS_RTOL)
    assert int(state.step) == step.count
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    stats = jax.device_get(state.batch_stats)
    want = {"param": convert_net_variables({"params": jax.device_get(state.params),
                                            "batch_stats": stats}, net),
            "exp_avg": convert_net_variables({"params": jax.device_get(adam.mu),
                                              "batch_stats": stats}, net),
            "exp_avg_sq": convert_net_variables({"params": jax.device_get(adam.nu),
                                                 "batch_stats": stats}, net)}
    assert int(adam.count) == step.count
    for name, p in net.named_parameters():
        s = optimizer.state[p]
        assert float(s["step"]) == step.count
        for kind, got in (("param", p.detach()), ("exp_avg", s["exp_avg"]),
                          ("exp_avg_sq", s["exp_avg_sq"])):
            ref = want[kind][name]
            err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            assert err <= TENSOR_RTOL, (kind, name, err)


def test_cli_trains_and_its_last_checkpoint_gives_the_callback_stats(data, tmp_path,
                                                                     monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train", "--config", RECIPE, "--device", "cpu",
                                      "--cfg-options", *_overrides(str(tmp_path), data,
                                                                   num_epochs=1)])
    port_train.main()
    ckpt_dir = tmp_path / "ckpt"
    with open(ckpt_dir / "summary" / "metrics.jsonl") as f:
        (record,) = [json.loads(line) for line in f]
    args = _args(str(tmp_path), data)
    args.ckpt = str(ckpt_dir / f"{CONFIG_NAME}_last.ckpt")
    args.result_path = str(tmp_path / "result.json")
    stats = port_eval.evaluate(args, device="cpu")
    for name in fixture.STAT_NAMES:
        assert abs(float(stats[name]) - record[f"val/{name}"]) <= 1e-4, name

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_train.train(Config(**dict(vars(_args(str(tmp_path), data)), device=None)))


def test_a_failing_step_leaves_a_crash_checkpoint(data, tmp_path, monkeypatch):
    class FailingCallback(port_train.EvalCallback):
        def on_step_end(self, loss_vector):
            super().on_step_end(loss_vector)
            if len(self._loss_vectors) == 2:
                raise RuntimeError("injected")

    monkeypatch.setattr(port_train, "EvalCallback", FailingCallback)
    with pytest.raises(RuntimeError, match="injected"):
        port_train.train(_args(str(tmp_path), data, val_while_train=False))
    crash = load_checkpoint(str(tmp_path / "ckpt" / f"{CONFIG_NAME}_crash.ckpt"))
    assert crash["step"] == 2 and crash["optimizer"]["state"]


@pytest.mark.parametrize("options, match", [
    ({"parallel_mode": "pipeline"}, "unknown parallel_mode"),
    ({"device_pipeline": "full"}, "device input pipeline"),
    ({"distill_setting": {"teacher_backbone": "hrnet_w48"}}, "distillation"),
    ({"profile": True}, "leftovers"),
    ({"backbone_pretrained": True, "backbone_ckpt_url": "http://example.invalid/w.msgpack"},
     "leftovers: URL download"),
    ({"distributed_init": True}, "DDP"),
    ({"allow_divergent_knobs": True}, "refuses"),
    ({"some_new_knob": 1}, "does not read"),
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, dict) else None)
def test_unsupported_keys_raise(data, tmp_path, options, match):
    args = Config(**dict(vars(_args(str(tmp_path), data)), **options))
    with pytest.raises((NotImplementedError, ValueError), match=match):
        port_train.train(args)


def test_more_than_one_visible_gpu_raises(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = Config(**dict(vars(_args(str(tmp_path), data)), device="cuda"))
    with pytest.raises(NotImplementedError, match="DDP"):
        port_train.train(args)


def test_device_pipeline_and_prefetch_train(data, tmp_path):
    """``device_pipeline: true`` (the host stops at the crop; the step renders
    the targets) with ``device_prefetch`` (on the CPU, tensors one at a time)."""
    got = port_train.train(_args(str(tmp_path), data, "--ckpt", CKPT, device_pipeline=True,
                                 device_prefetch=2, num_epochs=1, val_while_train=False))
    (epoch,) = got["epochs"]
    assert epoch["steps"] == 4 and np.isfinite(epoch["loss"]) and epoch["metrics"] == {}
    assert got["step"] == got["start_step"] + 4
