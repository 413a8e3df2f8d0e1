"""The port's train entry with ``parallel_mode: fsdp`` in 4 gloo ranks, on the CPU.

hrnet_w32_tpu.yaml for the fixture's reduced HRNet on tiny_coco's train
split (the config and data of tests/test_torch_train_entry.py), with
``parallel_mode: fsdp`` and ``model_parallel: 2`` (a mesh of data 2 x
model 2), launched as ``tools/launch_pod.py`` launches the JAX entry
(tests/fixtures/fsdp_ranks.py, ``entry``, started once for the module). The
run resumes from the JAX fixture's adamw TrainState (``CKPT``), so that the
net it evaluates has learned something: the JAX state goes into the
unsharded net and optimizer, then the net is sharded and the optimizer
rebuilt over the shards takes the state. One epoch of 2 steps a rank with
EMA (decay 0.9, kept over the shards), then rank 0's callback evaluates an
unsharded copy and writes the checkpoints and their ``.ema`` files.

Checked here: every rank trained its shard of the records and holds each
large parameter as a shard, and rank 0 alone holds an eval copy; the last
checkpoint is the net gathered on the ranks after training, with the whole
optimizer state and the EMA beside it, in the file format of a
single-device run; the eval entry in this process (no process group) gives
the callback's stats on it with the EMA in place, and a nonzero AP; and a
single-process run resumes from it. A second run in the same ranks, from
the fixture's initialisation with ``val_while_train: false``, trains and
writes its last checkpoint from the gathered net, with no eval copy on any
rank.
"""
import json
import os

import numpy as np
import pytest
import torch

from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.tools import train as port_train
from mindpose_tpu_torch.utils.checkpoint import load_checkpoint, load_ema
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import ddp_ranks, tiny_coco
from tests.fixtures.eval_checks import CKPT, RECORD, register_port_backbone
from tests.test_torch_train_entry import CONFIG_NAME, RECIPE, SEED, TRAIN_IMAGES, _overrides
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

WORLD = 4
MODEL_PARALLEL = 2
BATCH = 8  # per card: 2 * TRAIN_IMAGES = 64 records, 16 a rank, 2 steps an epoch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fsdp_entry"))
    data = (tiny_coco.write_split(os.path.join(root, "train"), TRAIN_IMAGES,
                                  tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))

    def argv(ckpt_dir, *flags, **extra):
        return ["--config", RECIPE, "--device", "cpu", "--seed", str(SEED), *flags,
                "--cfg-options", *_overrides(root, data, num_epochs=1, batch_size=BATCH,
                                             warmup=1, ckpt_save_dir=ckpt_dir, **extra)]

    ckpt_dir = os.path.join(root, "ckpt")
    no_eval_dir = os.path.join(root, "ckpt_no_eval")
    with open(os.path.join(root, "argv.json"), "w") as f:
        json.dump({"train": argv(ckpt_dir, "--ckpt", CKPT, parallel_mode="fsdp",
                                 model_parallel=MODEL_PARALLEL, ema_decay=0.9),
                   "no_eval": argv(no_eval_dir, parallel_mode="fsdp",
                                   model_parallel=MODEL_PARALLEL, val_while_train=False)}, f)
    ddp_ranks.start_ranks("entry", WORLD, root, module="tests.fixtures.fsdp_ranks")

    def records(run):
        got = []
        for rank in range(WORLD):
            with open(os.path.join(root, f"{run}_rank{rank}.json")) as f:
                got.append(json.load(f))
        return got

    with open(os.path.join(ckpt_dir, "summary", "metrics.jsonl")) as f:
        (metrics,) = [json.loads(line) for line in f]
    register_port_backbone()
    return {"root": root, "data": data, "ckpt_dir": ckpt_dir, "records": records("train"),
            "metrics": metrics, "argv": argv,
            "gathered": torch.load(os.path.join(root, "train_gathered.pt")),
            "last": os.path.join(ckpt_dir, f"{CONFIG_NAME}_last.ckpt"),
            "no_eval": {"records": records("no_eval"),
                        "gathered": torch.load(os.path.join(root, "no_eval_gathered.pt")),
                        "ckpt_dir": no_eval_dir,
                        "last": os.path.join(no_eval_dir, f"{CONFIG_NAME}_last.ckpt")}}


def test_every_rank_trains_its_shard_on_a_2_by_2_mesh(ranks):
    for rank, r in enumerate(ranks["records"]):
        assert r["rank"] == rank and r["world"] == WORLD
        assert r["mesh_lines"] == ["fsdp: mesh {'data': 2, 'model': 2}"]
        (epoch,) = r["epochs"]
        assert epoch["steps"] == 2 and epoch["images"] == 2 * BATCH
        assert np.isfinite(epoch["loss"]) and r["step"] == r["start_step"] + 2
        assert r["start_step"] == ranks["records"][0]["start_step"] > 0  # the JAX state's
        # the net, and on rank 0 alone the eval copy
        assert r["nets"] == (2 if rank == 0 else 1)
        for name, (local, full) in r["shards"].items():
            if full >= 2 ** 16:
                assert local * MODEL_PARALLEL == full, name
    assert ranks["records"][0]["evaluations"] == 1
    assert all(r["evaluations"] == 0 for r in ranks["records"][1:])
    assert ranks["records"][0]["copy_is_gathered"]


def test_the_last_checkpoint_is_the_gathered_net_in_the_single_device_format(ranks):
    ckpt = load_checkpoint(ranks["last"])
    gathered = ranks["gathered"]
    assert set(ckpt["net"]) == set(gathered)
    for name, value in gathered.items():
        assert torch.equal(ckpt["net"][name], value), name
    assert ckpt["step"] == ranks["records"][0]["step"]
    # torch's numbering over the groups, each moment whole
    net = port_train.create_network(RECORD["config"]["backbone_name"], "hrnet_head",
                                    num_joints=17)
    params = dict(net.named_parameters())
    optim = ckpt["optimizer"]
    numbered = [i for group in optim["param_groups"] for i in group["params"]]
    assert sorted(numbered) == list(range(len(params))) == sorted(optim["state"])
    shapes = sorted(tuple(p.shape) for p in params.values())
    assert sorted(tuple(s["exp_avg"].shape) for s in optim["state"].values()) == shapes
    assert sorted(tuple(s["exp_avg_sq"].shape) for s in optim["state"].values()) == shapes
    # the EMA, kept over the shards, gathered whole beside it
    ema = load_ema(ranks["last"] + ".ema")
    assert {n: tuple(v.shape) for n, v in ema.items()} == {
        n: tuple(p.shape) for n, p in params.items()}
    assert any(not torch.equal(ema[n], gathered[n]) for n in ema)


def test_without_evaluation_it_trains_and_saves_the_gathered_net(ranks):
    """``val_while_train: false`` with the recipe's ``save_last``: no rank
    builds an eval copy, and the last checkpoint is still written from the
    state every rank gathers."""
    run = ranks["no_eval"]
    for rank, r in enumerate(run["records"]):
        assert r["rank"] == rank and r["nets"] == 1 and r["evaluations"] == 0
        (epoch,) = r["epochs"]
        assert epoch["steps"] == 2 and np.isfinite(epoch["loss"]) and epoch["metrics"] == {}
        assert r["step"] == r["start_step"] + 2 == 2
    ckpt = load_checkpoint(run["last"])
    assert ckpt["step"] == 2 and set(ckpt["net"]) == set(run["gathered"])
    for name, value in run["gathered"].items():
        assert torch.equal(ckpt["net"][name], value), name
    assert not os.path.exists(os.path.join(run["ckpt_dir"], f"{CONFIG_NAME}_best.ckpt"))


def test_the_eval_entry_on_it_gives_rank_0_s_nonzero_ap(ranks):
    """The callback evaluated the EMA parameters (with the net's running
    statistics): the eval entry on the last checkpoint with them in place
    gives its stats."""
    ckpt = load_checkpoint(ranks["last"])
    ckpt["net"].update(load_ema(ranks["last"] + ".ema"))
    with_ema = os.path.join(ranks["root"], "last_with_ema.ckpt")
    torch.save(ckpt, with_ema)
    args = port_train.parse_train_args(ranks["argv"](ranks["ckpt_dir"]))
    args.ckpt = with_ema
    args.result_path = os.path.join(ranks["root"], "result.json")
    stats = port_eval.evaluate(args, device="cpu")
    assert ranks["metrics"]["val/AP"] > 0
    for name in fixture.STAT_NAMES:
        assert abs(float(stats[name]) - ranks["metrics"][f"val/{name}"]) <= 1e-4, name


def test_a_single_process_resumes_from_it(ranks, tmp_path):
    args = port_train.parse_train_args(ranks["argv"](str(tmp_path / "ckpt"), "--ckpt",
                                                     ranks["last"], val_while_train=False,
                                                     parallel_mode="fsdp"))
    got = port_train.train(args)
    assert got["start_step"] == load_checkpoint(ranks["last"])["step"]
    assert got["step"] == got["start_step"] + 2 * TRAIN_IMAGES // BATCH and np.isfinite(got["epochs"][0]["loss"])
