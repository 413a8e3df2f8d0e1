"""The port's train entry data-parallel in 2 gloo ranks, on the CPU.

hrnet_w32_tpu.yaml for the fixture's reduced HRNet on tiny_coco's train
split (the config and data of tests/test_torch_train_entry.py), launched as
``tools/launch_pod.py`` launches the JAX entry: each rank a fresh
interpreter with the ``MINDPOSE_*`` variables and ``--device cpu``
(tests/fixtures/ddp_ranks.py, ``entry``), started once for the module.
One epoch with the callback evaluating, then a run whose callback raises
after the second step. The ranks share the checkpoint directory.
"""
import json
import os

import numpy as np
import pytest
import torch

from mindpose_tpu_torch.utils.checkpoint import load_checkpoint
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import ddp_ranks, tiny_coco
from tests.test_torch_train_entry import CONFIG_NAME, RECIPE, SEED, TRAIN_IMAGES, _overrides
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

WORLD = 2
BATCH = 16  # per card: 64 records, 32 a rank, 2 steps an epoch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_entry"))
    data = (tiny_coco.write_split(os.path.join(root, "train"), TRAIN_IMAGES,
                                  tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))

    def argv(ckpt_dir, **extra):
        return ["--config", RECIPE, "--device", "cpu", "--seed", str(SEED), "--cfg-options",
                *_overrides(root, data, num_epochs=1, batch_size=BATCH,
                            warmup=1, ckpt_save_dir=ckpt_dir, **extra)]

    ckpt_dir, crash_dir = os.path.join(root, "ckpt"), os.path.join(root, "crash")
    with open(os.path.join(root, "argv.json"), "w") as f:
        json.dump({"train": argv(ckpt_dir), "eval": argv(ckpt_dir),
                   "crash": argv(crash_dir, val_while_train=False),
                   "ckpt_dir": ckpt_dir, "config_name": CONFIG_NAME}, f)
    outputs = ddp_ranks.start_ranks("entry", WORLD, root)
    records = []
    for rank in range(WORLD):
        with open(os.path.join(root, f"entry_rank{rank}.json")) as f:
            records.append(json.load(f))
    finals = [torch.load(os.path.join(root, f"entry_final_rank{r}.pt")) for r in range(WORLD)]
    return {"root": root, "ckpt_dir": ckpt_dir, "crash_dir": crash_dir, "records": records,
            "finals": finals, "outputs": outputs}


def test_both_ranks_train_their_shard_in_a_world_of_2(ranks):
    for rank, r in enumerate(ranks["records"]):
        assert r["rank"] == rank and r["world"] == WORLD
        (epoch,) = r["epochs"]
        # 64 records, 32 a rank: 2 steps of 16 each
        assert epoch["steps"] == 2 and epoch["images"] == 2 * BATCH and r["step"] == 2
        assert np.isfinite(epoch["loss"])


def test_rank_0_alone_evaluates_and_writes(ranks):
    rank0, rank1 = ranks["records"]
    assert rank0["evaluations"] == 1 and rank1["evaluations"] == 0
    assert rank0["epochs"][0]["metrics"]["AP"] >= 0 and rank1["epochs"][0]["metrics"] == {}
    assert sorted(name for _, name in rank0["saves"]) == [f"{CONFIG_NAME}_best.ckpt",
                                                           f"{CONFIG_NAME}_last.ckpt"]
    assert rank1["saves"] == []
    with open(os.path.join(ranks["ckpt_dir"], "summary", "metrics.jsonl")) as f:
        (record,) = [json.loads(line) for line in f]
    assert record["epoch"] == 1 and "val/AP" in record
    assert sorted(os.listdir(ranks["ckpt_dir"])) == [
        f"{CONFIG_NAME}_best.ckpt", f"{CONFIG_NAME}_last.ckpt", "summary"]


def test_final_replicas_and_logged_losses_are_equal(ranks):
    first, second = ranks["finals"]
    assert set(first) == set(second)
    for name, value in first.items():
        assert torch.equal(second[name], value), name
    last = load_checkpoint(os.path.join(ranks["ckpt_dir"], f"{CONFIG_NAME}_last.ckpt"))
    for name, value in first.items():
        assert torch.equal(last["net"][name], value), name
    rank0, rank1 = ranks["records"]
    assert rank0["epochs"][0]["loss"] == rank1["epochs"][0]["loss"]
    (line0,), (line1,) = rank0["epoch_lines"], rank1["epoch_lines"]
    assert line0.split(", time:")[0] == line1.split(", time:")[0]  # epoch, loss, lr
    with open(os.path.join(ranks["ckpt_dir"], "summary", "metrics.jsonl")) as f:
        logged = json.loads(f.readline())["train/loss"]
    assert f"loss: {logged:.6f}," in line1


def test_callback_stats_equal_the_eval_entry_s(ranks):
    """Rank 0's callback against its last checkpoint through the eval entry
    (``compare_callback_with_eval_entry``): the same images and persons, the
    keypoints within 1e-4, and the stats within 1e-4, as
    tests/test_torch_train_entry.py holds them."""
    rank0 = ranks["records"][0]
    same = rank0["same"]
    assert same["evaluations"] == 1 and same["persons"] > 0
    assert same["pred_err"] <= 1e-4
    with open(os.path.join(ranks["ckpt_dir"], "summary", "metrics.jsonl")) as f:
        record = json.loads(f.readline())
    for name in fixture.STAT_NAMES:
        assert abs(rank0["eval_entry_stats"][name] - record[f"val/{name}"]) <= 1e-4, name


def test_a_crash_leaves_one_crash_checkpoint_from_rank_0(ranks):
    rank0, rank1 = ranks["records"]
    assert rank0["crash"] == rank1["crash"] == "injected"
    assert rank0["crash_saves"] == [["crash", f"{CONFIG_NAME}_crash.ckpt"]]
    assert rank1["crash_saves"] == []
    assert [n for n in os.listdir(ranks["crash_dir"]) if n.endswith(".ckpt")] == [
        f"{CONFIG_NAME}_crash.ckpt"]
    crash = load_checkpoint(os.path.join(ranks["crash_dir"], f"{CONFIG_NAME}_crash.ckpt"))
    assert crash["step"] == 2 and crash["optimizer"]["state"]
