"""The port's data-parallel training against the JAX package's, on the CPU.

The reference is the JAX step on a 4-device CPU mesh (tests/conftest.py
forces 8 host devices): ``build_train_step(..., mesh=create_mesh(
jax.devices()[:4]))`` with its batch sharded by ``shard_batch``, each
device's shard normalized with its own BatchNorm statistics, the
gradients, the loss and the running statistics ``pmean``ed. The port runs
in 4 gloo ranks (tests/fixtures/ddp_ranks.py, started once for the module
as fresh interpreters), rank *i* given the *i*-th quarter of the same
global batch of 8: DDP averages the gradients, and the step all-reduces
the loss and the running statistics to their mean. The net is the reduced
HRNet of tests/test_torch_hrnet.py (``CFG``, width 8, with BatchNorm), its
weights converted from the JAX variables; the optimizer and schedule are
the recipe's, as in tests/test_torch_train_step.py, whose float64 JAX
reference and tolerances this file takes over. Both sides run in float64
here: a shard of 2 crops leaves stage 4's last branch 8 values per channel
for its train-mode BatchNorm, and with the port in float32 a parameter of
the stem's conv lay 1.2e-4 from JAX's after 3 steps (measured), beyond
``_adam_tolerance`` (tests/test_torch_simple_baseline.py compares in
float64 for the same reason).

The same run holds the port's DDP at world 2 against ``accum_steps=2`` in
one process, and its collectives; the loader's shards are held against
JAX's loader in this process.
"""
import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.data import device_pipeline as jax_device_pipeline
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel.mesh import create_mesh, replicated_sharding
from mindpose_tpu.parallel.train import build_train_step as jax_build_train_step
from mindpose_tpu.parallel.train import create_train_state, shard_batch
from mindpose_tpu.scheduler.schedulers import create_lr_scheduler as jax_create_scheduler
from mindpose_tpu_torch.data import create_dataset, create_pipeline, device_pipeline
from mindpose_tpu_torch.data.column_names import FINAL_COLUMN_MAP
from mindpose_tpu_torch.data.loader import DataLoader
from mindpose_tpu_torch.models.common import BatchNorm2d
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from tests.fixtures import ddp_ranks
from tests.helpers import make_tiny_coco
from tests.test_torch_frame_loader import (
    BUCKET,
    FULL_COLUMNS,
    SETTING,
    TRANSFORMS,
    _assert_epochs_equal,
    _epochs,
    _full_transforms,
    _loader,
)
from tests.test_torch_hrnet import _randomize
from tests.test_torch_train_step import (
    HEATMAP_SIZE,
    IMAGE_SIZE,
    MEAN,
    STD,
    YAML,
    _adam_gradients,
    _adam_tolerance,
    _jax_net,
    _jax_side,
    _keypoints,
    _params_sd,
    _port_side,
    _running_stats,
    _schedule_kwargs,
)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

WORLD = 4
GLOBAL_BATCH = 8
MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch


def _variables():
    """The reduced HRNet's JAX variables: shapes from ``jax.eval_shape`` (no
    compile), kernels drawn from a numpy seed with flax's lecun-normal
    variance, then BatchNorm and the head as tests/test_torch_train_step.py
    draws them."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda key, x: _jax_net().init(key, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3), jnp.float32))

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)  # biases and the statistics _randomize draws

    variables = _randomize(jax.tree_util.tree_map_with_path(draw, shapes), rng)
    head = variables["params"]["head"]["head"]
    head["kernel"] = (0.2 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    return variables


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _jax_mesh_steps(variables, image, kpts, accum_steps):
    """The JAX step on a 4-device mesh in float64, 3 steps: per step the loss
    vector, the state_dict after it and the gradient it took (the pmeaned
    one, read back from adam's first moment)."""
    out = []
    with jax.enable_x64(True):
        nwl_j, pp_j = _jax_side(jnp.float64)
        mesh = create_mesh(jax.devices()[:WORLD])
        variables64 = {"params": _f64(variables["params"]),
                       "batch_stats": _f64(variables["batch_stats"])}
        schedule_j = jax_create_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
        tx = jax_create_optimizer(variables64["params"], learning_rate=schedule_j, **YAML)
        # replicated on the mesh from the start, as every later state is: one compile
        state = jax.device_put(create_train_state(variables64, tx), replicated_sharding(mesh))
        step_j = jax_build_train_step(nwl_j, tx, mesh=mesh, donate=False, preprocess=pp_j,
                                      accum_steps=accum_steps)
        mu = None
        for _ in range(ddp_ranks.STEPS):
            state, loss_j = step_j(state, *shard_batch([image, kpts], mesh))
            grads, mu = _adam_gradients(state.opt_state, mu)
            out.append({"loss": np.asarray(loss_j),
                        "state": _params_sd(state.params, state.batch_stats),
                        "grads": _params_sd(grads, variables["batch_stats"])})
    return out


def _accum_reference(variables, image, kpts):
    """The port in this process at ``accum_steps=2`` on the whole batch, on
    one thread as a rank runs: per step the state_dict after it, the
    gradients it took, and each BatchNorm's running statistics before the
    step and after its first microbatch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _accum_steps(variables, image, kpts)
    finally:
        torch.set_num_threads(threads)


def _accum_steps(variables, image, kpts):
    net, nwl, pp = _port_side(variables)
    schedule = create_lr_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
    step = build_train_step(nwl, create_optimizer(net, **YAML), schedule, preprocess=pp,
                            accum_steps=2)
    names = {m: n for n, m in net.named_modules() if isinstance(m, BatchNorm2d)}
    seen = []

    def record(module, _, __):
        seen.append((names[module], module.running_mean.clone(), module.running_var.clone()))

    for module in names:
        module.register_forward_hook(record)
    steps = []
    for _ in range(ddp_ranks.STEPS):
        before = _running_stats(net.state_dict())
        before = {k: v.clone() for k, v in before.items()}
        seen.clear()
        step(image, kpts)
        first = {}
        for name, mean, var in seen[:len(names)]:  # the first microbatch's forward
            first[f"{name}.running_mean"], first[f"{name}.running_var"] = mean, var
        steps.append({"state": {k: v.clone() for k, v in net.state_dict().items()},
                      "grads": {n: p.grad.clone() for n, p in net.named_parameters()},
                      "before": before, "first": first})
    return steps


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("ddp"))
    variables = _variables()
    net = _port_side(variables)[0]
    torch.save({"net": net, "state": net.state_dict()}, os.path.join(out_dir, "net.pt"))
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (GLOBAL_BATCH, 64, 48, 3)).astype(np.uint8)
    kpts = _keypoints(rng, GLOBAL_BATCH)
    np.savez(os.path.join(out_dir, "batch.npz"), image=image, keypoints=kpts)
    with open(os.path.join(out_dir, "setup.json"), "w") as f:
        json.dump({"optimizer": YAML, "schedule": _schedule_kwargs(),
                   "preprocess": dict(image_size=IMAGE_SIZE, heatmap_size=HEATMAP_SIZE,
                                      normalize_mean=MEAN, normalize_std=STD, sigma=2.0)}, f)
    # the ranks run while this process compiles and runs the JAX steps
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        started = pool.submit(ddp_ranks.start_ranks, "step", WORLD, out_dir)
        want = {a: _jax_mesh_steps(variables, image, kpts, a) for a in ddp_ranks.ACCUM_STEPS}
        accum = _accum_reference(variables, torch.from_numpy(image), torch.from_numpy(kpts))
        started.result()
    load = lambda name: torch.load(os.path.join(out_dir, name), weights_only=False)  # noqa: E731
    got = [load(f"step_rank{r}.pt") for r in range(WORLD)]
    collectives = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"collectives_rank{r}.json")) as f:
            collectives.append(json.load(f))
    return {"start": net.state_dict(), "params": [n for n, _ in net.named_parameters()],
            "want": want, "got": got, "accum": accum,
            "world2": [load(f"world2_rank{r}.pt") for r in range(2)],
            "collectives": collectives}


@pytest.mark.parametrize("accum_steps", ddp_ranks.ACCUM_STEPS)
def test_four_ranks_match_the_jax_step_on_a_4_device_mesh(ranks, accum_steps):
    """The tolerances of test_torch_train_step.py::test_three_steps_match_jax:
    losses rtol 1e-5; BatchNorm running statistics rtol 1e-4 (atol 1e-6);
    parameters as ``_adam_tolerance`` says, after each of the 3 steps (the
    yaml's adamw, warmup shortened to 2); the port's 4 ranks in float64
    against JAX's 4 devices in float64."""
    want, got = ranks["want"][accum_steps], ranks["got"][0][f"accum{accum_steps}"]
    start = {k: ranks["start"][k] for k in ranks["params"]}
    schedule = create_lr_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
    lrs = [schedule(i) for i in range(len(want))]
    loose = 0
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g["loss"].numpy(), w["loss"], rtol=1e-5, err_msg=f"step {i}")
        for name, v in _running_stats(w["state"]).items():
            np.testing.assert_allclose(g["state"][name].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {name}")
        tol = _adam_tolerance([x["grads"] for x in want[:i + 1]], start, lrs[:i + 1])
        for name in start:
            diff = (g["state"][name].double() - w["state"][name]).abs()
            assert bool((diff <= tol[name]).all()), (i, name, float(diff.max()))
            if i == len(want) - 1:
                loose += int((diff > 1e-5).sum())
    for name in start:  # every tensor moved
        assert float((want[-1]["state"][name] - start[name].double()).abs().max()) > 1e-4, name
    assert loose <= 1e-4 * sum(t.numel() for t in start.values())
    assert lrs[0] == 0.0 and lrs[2] > 0


@pytest.mark.parametrize("accum_steps", ddp_ranks.ACCUM_STEPS)
def test_all_ranks_are_bitwise_equal_after_every_step(ranks, accum_steps):
    """Parameters, running statistics and losses, as the JAX step's replicas."""
    runs = [g[f"accum{accum_steps}"] for g in ranks["got"]]
    for i in range(ddp_ranks.STEPS):
        for r in range(1, WORLD):
            assert torch.equal(runs[r][i]["loss"], runs[0][i]["loss"]), (i, r)
            for name, v in runs[0][i]["state"].items():
                assert torch.equal(runs[r][i]["state"][name], v), (i, r, name)


def test_world_2_against_accum_steps_2_in_one_process(ranks):
    """Two ranks each given half of the batch take the gradients that one
    process takes over two microbatches of those halves, in float32: the
    parameters agree as ``_adam_tolerance`` says (1e-5, or twice the summed
    lr where a gradient is below 1e-4 of its tensor's largest). The running
    statistics do not: DDP averages two momentum updates of the step's
    start, m * prev + (1 - m) * s_i, where one process applies them in
    sequence. So, with A1 the one
    process's statistics after its first microbatch and A2 after its
    second, (1 - m) s_1 = A1 - m prev_1 and (1 - m) s_2 = A2 - m A1, and
    each step of the 2 ranks gives m prev + ((1 - m) s_1 + (1 - m) s_2) / 2
    from its own prev."""
    world2, accum = ranks["world2"], ranks["accum"]
    for i in range(ddp_ranks.STEPS):
        for name, v in world2[0][i]["state"].items():
            assert torch.equal(world2[1][i]["state"][name], v), (i, name)
    schedule = create_lr_scheduler("warmup_multi_step_decay", **_schedule_kwargs())
    lrs = [schedule(i) for i in range(ddp_ranks.STEPS)]
    start = {k: ranks["start"][k] for k in ranks["params"]}
    prev = _running_stats(ranks["start"])
    formula_err, accum_gap = 0.0, 0.0
    for i, (g, a) in enumerate(zip(world2[0], accum)):
        tol = _adam_tolerance([x["grads"] for x in accum[:i + 1]], start, lrs[:i + 1])
        for name in start:
            diff = (g["state"][name] - a["state"][name]).abs()
            assert bool((diff <= tol[name]).all()), (i, name, float(diff.max()))
        for name, got in _running_stats(g["state"]).items():
            a1, a2 = a["first"][name], a["state"][name]
            want = MOMENTUM * prev[name] + (a1 - MOMENTUM * a["before"][name]
                                            + a2 - MOMENTUM * a1) / 2
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {name}")
            formula_err = max(formula_err, float((got - want).abs().max()))
            accum_gap = max(accum_gap, float((got - a2).abs().max()))
        prev = _running_stats(g["state"])
    assert accum_gap > 100 * formula_err, (accum_gap, formula_err)


def test_collectives_in_the_four_ranks(ranks):
    for rank, c in enumerate(ranks["collectives"]):
        assert c["mean"] == [1.5, 3.0] and c["mean_dtype"] == "float32"
        assert c["records"] == [{"rank": r, "pred": list(range(r + 1)), "pred_is_array": True}
                                for r in range(WORLD)]
        assert c["main"] is (rank == 0)


# ------------------------------------------------------- the loader's shards

SHARD_OPTIONS = {
    "host": dict(transforms=TRANSFORMS),
    "frame_grouped_shuffle": dict(transforms=TRANSFORMS, frame_grouped_shuffle=True),
    "full-patch_grouped": dict(full=True, normalize=False, image_bucket=BUCKET,
                               patch_grouped_batching=True),
}
SHARD_BATCH = 2
HOST_COLUMNS = FINAL_COLUMN_MAP["topdown"]["train"] + ["bbox_ids", "image_file"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """12 frames of 3 persons each (36 records, 9 a rank)."""
    return make_tiny_coco(str(tmp_path_factory.mktemp("frames")), num_images=12,
                          people_per_img=3)


def _shard_loader(create_ds, create_pl, dp, fixture, name, rank):
    options = dict(SHARD_OPTIONS[name])
    if options.pop("full", False):
        transforms, columns = _full_transforms(dp), FULL_COLUMNS
    else:
        transforms, columns = options.pop("transforms"), HOST_COLUMNS
    img_root, ann = fixture

    def create_sharded(*args, **kwargs):
        return create_ds(*args, device_num=WORLD, rank_id=rank, **kwargs)

    return _loader(create_sharded, create_pl, (img_root, ann), transforms,
                   batch_size=SHARD_BATCH, final_columns=columns, **options)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("name", SHARD_OPTIONS)
def test_shard_equals_jax_loader_s_bitwise(frames, name, rank):
    """Each rank's batches over two epochs at one worker: the JAX loader's
    at the same device_num and rank_id."""
    want = _epochs(_shard_loader(jax_create_dataset, jax_create_pipeline, jax_device_pipeline,
                                 frames, name, rank))
    loader = _shard_loader(create_dataset, create_pipeline, device_pipeline, frames, name, rank)
    got = _epochs(loader)
    _assert_epochs_equal(got, want)
    assert loader.num_samples == 9 and len(got[0]) == 9 // SHARD_BATCH


@pytest.mark.parametrize("name", SHARD_OPTIONS)
def test_shards_hold_each_record_once_an_epoch(frames, name):
    """Together the 4 shards hold every record once an epoch, apart from
    what each rank's drop_remainder drops (one of its 9)."""
    records = DataLoader(create_dataset(*frames, is_train=True, config=SETTING)["dataset"], [],
                         ["bbox_ids"]).num_samples
    epochs = [_epochs(_shard_loader(create_dataset, create_pipeline, device_pipeline, frames,
                                    name, rank)) for rank in range(WORLD)]
    for e in range(2):
        seen = [(str(f), int(b)) for rank in range(WORLD) for batch in epochs[rank][e]
                for f, b in zip(batch["image_file"], batch["bbox_ids"])]
        assert len(seen) == len(set(seen)) == records - WORLD * (9 % SHARD_BATCH)


def test_shard_arguments_are_checked(frames):
    ds = create_dataset(*frames, is_train=True, config=SETTING)["dataset"]
    shard = DataLoader(ds, [], ["bbox_ids"], device_num=WORLD, rank_id=3, is_train=False)
    assert shard._epoch_indices().tolist() == list(range(3, 36, WORLD))
    with pytest.raises(ValueError, match="rank_id"):
        DataLoader(ds, [], ["bbox_ids"], device_num=2, rank_id=2)
