"""The port's training entry on the CPU: its CLI, its refusals and its other paths.

tests/test_torch_train_entry_jax_loop.py holds the entry against the JAX
package's training loop; this file shares its config and data with it:
hrnet_w32_tpu.yaml for the fixture's reduced HRNet (tests/fixtures, 8
channels per branch) on tiny_coco's train split, one loader worker, one
seed. Here: the CLI trains and its last checkpoint gives the callback's
stats through the eval entry; a failing step leaves a crash checkpoint at
the step reached; each config key the entry does not support raises
(``allow_divergent_knobs``; a key it does not read), and so does more than
one visible GPU outside a process group (tests/test_torch_ddp_entry.py
trains in two); ``distill_setting`` and ``model_parallel``, refused until
they were ported, train (tests/test_torch_fsdp_entry.py shards over four
ranks); ``device_pipeline: true`` with ``device_prefetch`` trains.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.tools import train as port_train
from mindpose_tpu_torch.utils.checkpoint import load_checkpoint
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import CKPT, RECORD, register_port_backbone
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "hrnet", "hrnet_w32_tpu.yaml")
CONFIG_NAME = "hrnet_w32_tpu"
TRAIN_IMAGES = 32  # 64 records: 4 steps per epoch at batch 16
SEED = 0


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
    ({"allow_divergent_knobs": True}, "refuses"),
    ({"some_new_knob": 1}, "does not read"),
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, dict) else None)
def test_unsupported_keys_raise(data, tmp_path, options, match):
    args = Config(**dict(vars(_args(str(tmp_path), data)), **options))
    with pytest.raises((NotImplementedError, ValueError), match=match):
        port_train.train(args)


# refused until distillation and FSDP were ported; each trains now
DISTILL_OPTIONS = {
    "distill_setting": {"teacher_backbone": RECORD["config"]["backbone_name"],
                        "teacher_head": RECORD["config"]["head_name"], "teacher_ckpt": CKPT},
    "loss": "joint_mse_distill", "loss_setting": {"use_target_weight": True, "alpha": 0.5}}


@pytest.mark.parametrize("options", [DISTILL_OPTIONS, {"model_parallel": 2}],
                         ids=["distill_setting", "model_parallel"])
def test_once_refused_keys_train(data, tmp_path, options):
    """``distill_setting``: the teacher (the eval fixture's JAX TrainState)
    appends its heatmaps and the callback logs both loss components.
    ``model_parallel`` in one process: not read, as the JAX entry reads it
    only for an FSDP mesh."""
    got = port_train.train(_args(str(tmp_path), data, num_epochs=1, val_while_train=False,
                                 **options))
    (epoch,) = got["epochs"]
    assert epoch["steps"] == 4 and np.isfinite(epoch["loss"])
    with open(tmp_path / "ckpt" / "summary" / "metrics.jsonl") as f:
        (record,) = [json.loads(line) for line in f]
    if "distill_setting" in options:
        assert record["train/loss_0"] > 0 and record["train/loss_1"] > 0
        # the components of the epoch's mean loss vector sum to its mean loss
        assert record["train/loss_0"] + record["train/loss_1"] == pytest.approx(epoch["loss"],
                                                                               rel=1e-5)
    else:
        assert "train/loss_1" not in record
        parsed = port_train.parse_train_args(["--config", RECIPE, "--cfg-options",
                                              "model_parallel=2"])
        assert parsed.model_parallel == 2


def test_more_than_one_visible_gpu_raises(data, tmp_path, monkeypatch):
    """Outside a process group: the port runs one process per card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = Config(**dict(vars(_args(str(tmp_path), data)), device="cuda"))
    with pytest.raises(NotImplementedError, match="one process per card.*torchrun"):
        port_train.train(args)


def test_device_pipeline_and_prefetch_train(data, tmp_path):
    """``device_pipeline: true`` (the host stops at the crop; the step renders
    the targets) with ``device_prefetch`` (on the CPU, tensors one at a time)."""
    got = port_train.train(_args(str(tmp_path), data, "--ckpt", CKPT, device_pipeline=True,
                                 device_prefetch=2, num_epochs=1, val_while_train=False))
    (epoch,) = got["epochs"]
    assert epoch["steps"] == 4 and np.isfinite(epoch["loss"]) and epoch["metrics"] == {}
    assert got["step"] == got["start_step"] + 4
