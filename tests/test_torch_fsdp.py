"""The port's FSDP step against the JAX package's, on the CPU.

The reference is ``build_fsdp_train_step`` (mindpose_tpu/parallel/fsdp.py)
on a 4-device CPU mesh of shape (data, model) = (1, 4) or (2, 2)
(tests/conftest.py forces 8 host devices): one GSPMD program over the
global batch of 8, split over both axes, with the parameters and AdamW
moments sharded over ``model`` (``min_size`` 4096, so that the tiny nets'
large leaves shard). The port runs in 4 gloo ranks
(tests/fixtures/fsdp_ranks.py, started once for the module as fresh
interpreters) with ``parallel/fsdp.shard_net`` on the same mesh shape, each
rank given its slice of every microbatch of the same global batch.

Two nets, both sides in float64, 3 steps of AdamW (lr 1e-3, weight decay
0.05, bias and norm parameters not decayed), at ``accum_steps`` 1 and 2:

- the tiny ViTPose net of tests/parallel/test_fsdp.py (patch 8, width 64,
  depth 2, 2 heads, a 2-deconv head of 32 filters, 64x64 crops), the JAX
  ViT's float32 LayerNorms and loss read as float64 (``Float64Numpy``).
  Loss vectors within rtol 1e-10, and every tensor within 1e-6 of its
  largest entry after each step, the bound of
  tests/test_torch_vitpose_train.py's float64 steps (measured worst:
  5.6e-8, a query/key/value weight; the single-device steps of the two
  packages are as far apart);
- the reduced HRNet of tests/test_torch_ddp.py, whose BatchNorm takes the
  global batch's statistics in both: losses rtol 1e-5, running statistics
  rtol 1e-4 and parameters as ``_adam_tolerance`` says, the tolerances of
  tests/test_torch_ddp.py (the port renders its targets in float32;
  measured worst: 1.4e-7 against the 1e-5 of ``_adam_tolerance``).

The JAX HRNet runs on the (1, 4) mesh at ``accum_steps`` 1 and on (2, 2) at
2; its numbers do not depend on the mesh (one program over the global
batch), and every port run is held to the JAX run of its ``accum_steps``.

Also: each parameter of at least 4096 elements, and both of its AdamW
moments, is held as a local shard smaller than the whole; all ranks return
the same loss; a fresh sharded optimizer that loads the gathered optimizer
state holds each rank's moments bit for bit; and the HRNet with ``remat``
under FSDP (the recompute all-reducing its BatchNorm statistics again)
gives the plain run's step.
"""
import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mindpose_tpu.models.backbones.vit as jax_vit_module
from mindpose_tpu.models.backbones.vit import ViT as JaxViT
from mindpose_tpu.models.loss import mse as jax_mse_module
from mindpose_tpu.models.model_factory import create_head as jax_create_head
from mindpose_tpu.models.model_factory import create_loss as jax_create_loss
from mindpose_tpu.models.model_factory import create_network_with_loss as jax_create_nwl
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu.optim.optim_factory import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel.fsdp import build_fsdp_train_step, fsdp_batch_spec, shard_train_state
from mindpose_tpu.parallel.mesh import create_mesh
from mindpose_tpu.parallel.train import create_train_state, shard_batch
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.models.heads import SimpleBaselineHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.parallel.fsdp import fsdp_shard_dim
from tests.fixtures import ddp_ranks, fsdp_ranks
from tests.test_torch_bottomup_loss import Float64Numpy
from tests.test_torch_ddp import _f64, _variables
from tests.test_torch_train_step import (
    HEATMAP_SIZE,
    IMAGE_SIZE,
    MEAN,
    STD,
    _adam_gradients,
    _adam_tolerance,
    _jax_side,
    _keypoints,
    _params_sd,
    _port_side,
    _running_stats,
)
from tests.test_torch_vit import fill_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

WORLD = 4
GLOBAL_BATCH = 8
MIN_SIZE = 4096  # tests/parallel/test_fsdp.py's test-scale threshold
OPTIMIZER = dict(name="adamw", learning_rate=1e-3, weight_decay=0.05, filter_bias_and_bn=True)
VIT = dict(patch_size=8, hidden_dim=64, depth=2, num_heads=2)
HEAD = dict(num_deconv_layers=2, num_deconv_filters=(32, 32), num_deconv_kernels=(4, 4))
VIT_LOSS_RTOL = 1e-10
VIT_RTOL = 1e-6  # of each tensor's largest entry
JAX_HRNET_RUNS = {1: (1, 4), 2: (2, 2)}  # accum_steps -> the mesh JAX's HRNet runs on


def _jax_vit_net(dtype=jnp.float32):
    return JaxNet(backbone=JaxViT(dtype=dtype, **VIT),
                  head=jax_create_head("simple_baseline_head", in_channels=VIT["hidden_dim"],
                                       num_joints=17, dtype=dtype, **HEAD))


def _port_vit_net():
    return Net(ViT(image_size=(64, 64), **VIT),
               SimpleBaselineHead(in_channels=VIT["hidden_dim"], num_joints=17, **HEAD))


def _vit_variables():
    shapes = jax.eval_shape(lambda: _jax_vit_net().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    return fill_variables(shapes, np.random.RandomState(30))


def _jax_fsdp_steps(nwl, variables, batch, mesh_shape, accum_steps, preprocess=None):
    """JAX's FSDP step in float64 on a (data, model) mesh of 4 devices, 3
    steps: per step the loss vector and the state as the port's state_dict."""
    mesh = create_mesh(jax.devices()[:WORLD], data_parallel=mesh_shape[0],
                       model_parallel=mesh_shape[1])
    variables64 = {"params": _f64(variables["params"]),
                   "batch_stats": _f64(variables.get("batch_stats", {}))}
    tx = jax_create_optimizer(variables64["params"], **OPTIMIZER)
    state = shard_train_state(create_train_state(variables64, tx), mesh, min_size=MIN_SIZE)
    step = build_fsdp_train_step(nwl, tx, mesh=mesh, state=state, preprocess=preprocess,
                                 donate=False, min_size=MIN_SIZE, accum_steps=accum_steps)
    sharded = shard_batch(batch, mesh, spec=fsdp_batch_spec())
    out, mu = [], None
    for _ in range(fsdp_ranks.STEPS):
        state, loss = step(state, *sharded)
        grads, mu = _adam_gradients(state.opt_state, mu)  # the gradient the step took
        out.append({"loss": np.asarray(loss), "grads": grads,
                    "params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.batch_stats)})
    return out


def _jax_references(vit_variables, vit_batch, hrnet_variables, hrnet_batch):
    want = {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_mse_module, "jnp", Float64Numpy())
        mp.setattr(jax_vit_module, "jnp", Float64Numpy())
        nwl = jax_create_nwl(_jax_vit_net(jnp.float64),
                             jax_create_loss("joint_mse", use_target_weight=True),
                             has_extra_inputs=True)
        skeleton = _port_vit_net()
        for mesh_shape in fsdp_ranks.MESHES:
            for accum_steps in fsdp_ranks.ACCUM_STEPS:
                steps = _jax_fsdp_steps(nwl, vit_variables, vit_batch, mesh_shape, accum_steps)
                want[fsdp_ranks.run_key("vit", mesh_shape, accum_steps)] = [
                    {"loss": s["loss"],
                     "state": convert_net_variables({"params": s["params"],
                                                     "batch_stats": s["batch_stats"]},
                                                    skeleton),
                     "grads": convert_net_variables({"params": s["grads"],
                                                     "batch_stats": s["batch_stats"]},
                                                    skeleton)} for s in steps]
        nwl_h, pp_h = _jax_side(jnp.float64)
        for accum_steps, mesh_shape in JAX_HRNET_RUNS.items():
            steps = _jax_fsdp_steps(nwl_h, hrnet_variables, hrnet_batch, mesh_shape, accum_steps,
                                    preprocess=pp_h)
            want[f"hrnet-accum{accum_steps}"] = [
                {"loss": s["loss"], "state": _params_sd(s["params"], s["batch_stats"]),
                 "grads": _params_sd(s["grads"], s["batch_stats"])} for s in steps]
    return want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("fsdp"))
    vit_variables = _vit_variables()
    vit = _port_vit_net()
    vit.load_state_dict(convert_net_variables(vit_variables, vit), strict=True)
    hrnet_variables = _variables()
    hrnet = _port_side(hrnet_variables)[0]
    for name, net in (("vit", vit), ("hrnet", hrnet)):
        torch.save({"net": net, "state": net.state_dict()}, os.path.join(out_dir, f"{name}.pt"))
    rng = np.random.RandomState(31)
    vit_batch = (0.05 * rng.standard_normal((GLOBAL_BATCH, 64, 64, 3)),  # NHWC
                 rng.uniform(0, 1, (GLOBAL_BATCH, 32, 32, 17)),
                 rng.uniform(0, 1, (GLOBAL_BATCH, 17)))
    np.savez(os.path.join(out_dir, "vit_batch.npz"),
             image=vit_batch[0].transpose(0, 3, 1, 2), target=vit_batch[1].transpose(0, 3, 1, 2),
             weight=vit_batch[2])
    image = rng.randint(0, 256, (GLOBAL_BATCH, 64, 48, 3)).astype(np.uint8)
    kpts = _keypoints(rng, GLOBAL_BATCH)
    np.savez(os.path.join(out_dir, "hrnet_batch.npz"), image=image, keypoints=kpts)
    with open(os.path.join(out_dir, "setup.json"), "w") as f:
        json.dump({"optimizer": OPTIMIZER,
                   "preprocess": dict(image_size=IMAGE_SIZE, heatmap_size=HEATMAP_SIZE,
                                      normalize_mean=MEAN, normalize_std=STD, sigma=2.0)}, f)
    # the ranks run while this process compiles and runs the JAX steps
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        started = pool.submit(ddp_ranks.start_ranks, "step", WORLD, out_dir,
                              module="tests.fixtures.fsdp_ranks")
        want = _jax_references(vit_variables, list(vit_batch), hrnet_variables, [image, kpts])
        started.result()
    got = [torch.load(os.path.join(out_dir, f"fsdp_rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return {"want": want, "got": got, "vit_start": vit.state_dict(),
            "hrnet_start": hrnet.state_dict(),
            "hrnet_params": [n for n, _ in hrnet.named_parameters()]}


RUNS = [(m, a) for m in fsdp_ranks.MESHES for a in fsdp_ranks.ACCUM_STEPS]
IDS = [f"{m[0]}x{m[1]}-accum{a}" for m, a in RUNS]


@pytest.mark.parametrize("mesh_shape, accum_steps", RUNS, ids=IDS)
def test_vit_steps_match_jax_s_fsdp_step(ranks, mesh_shape, accum_steps):
    key = fsdp_ranks.run_key("vit", mesh_shape, accum_steps)
    want, got = ranks["want"][key], ranks["got"][0][key]["steps"]
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g["loss"].numpy(), w["loss"], rtol=VIT_LOSS_RTOL,
                                   err_msg=f"step {i}")
        assert set(g["state"]) == set(w["state"])
        for name, v in w["state"].items():
            if name.endswith("num_batches_tracked"):  # flax keeps no count
                assert int(g["state"][name]) == (i + 1) * accum_steps, name
                continue
            v = v.double()
            err = float((g["state"][name] - v).abs().max())
            assert err <= VIT_RTOL * float(v.abs().max()), (i, name, err)
    for name, start in ranks["vit_start"].items():  # every tensor moved
        assert float((got[-1]["state"][name] - start.double()).abs().max()) > 1e-4, name


@pytest.mark.parametrize("mesh_shape, accum_steps", RUNS, ids=IDS)
def test_hrnet_steps_and_global_batch_statistics_match_jax(ranks, mesh_shape, accum_steps):
    """The BatchNorm running statistics are the global batch's (each
    microbatch's) in both, as one GSPMD program over the global batch takes
    them: rank-local statistics (DDP's) would miss them by far more than
    rtol 1e-4 on slices of 1-2 crops."""
    want = ranks["want"][f"hrnet-accum{accum_steps}"]
    got = ranks["got"][0][fsdp_ranks.run_key("hrnet", mesh_shape, accum_steps)]["steps"]
    start = {k: ranks["hrnet_start"][k] for k in ranks["hrnet_params"]}
    lrs = [OPTIMIZER["learning_rate"]] * len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g["loss"].numpy(), w["loss"], rtol=1e-5, err_msg=f"step {i}")
        for name, v in _running_stats(w["state"]).items():
            np.testing.assert_allclose(g["state"][name].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {name}")
        tol = _adam_tolerance([x["grads"] for x in want[:i + 1]], start, lrs[:i + 1])
        for name in start:
            diff = (g["state"][name] - w["state"][name].double()).abs()
            assert bool((diff <= tol[name]).all()), (i, name, float(diff.max()))
    for name in start:
        assert float((want[-1]["state"][name] - start[name].double()).abs().max()) > 1e-4, name


@pytest.mark.parametrize("net", ["vit", "hrnet"])
@pytest.mark.parametrize("mesh_shape, accum_steps", RUNS, ids=IDS)
def test_large_leaves_and_their_moments_are_sharded(ranks, net, mesh_shape, accum_steps):
    """Each parameter of at least ``MIN_SIZE`` elements, and its AdamW
    ``exp_avg`` and ``exp_avg_sq``, is held as a shard smaller than the
    whole, about 1 / model of it, on every rank; the shards of each leaf add
    up to it (the rule's dim divides evenly); every rank ends each step with
    the same loss vector; and the gathered optimizer state reloads into a
    fresh sharded optimizer bit for bit."""
    key = fsdp_ranks.run_key(net, mesh_shape, accum_steps)
    model = mesh_shape[1]
    runs = [g[key] for g in ranks["got"]]
    large = [n for n, (_, full) in runs[0]["sizes"].items() if full >= MIN_SIZE]
    assert large
    for run in runs:
        for name in large:
            local, full = run["sizes"][name]
            assert local < full and local * model >= full, (name, local, full)
            assert run["moments"][name] == (local, local), name
        assert run["reloaded"]
    for name in large:
        if runs[0]["sizes"][name][1] % model == 0:
            assert sum(r["sizes"][name][0] for r in runs[:model]) == runs[0]["sizes"][name][1]
    for i in range(fsdp_ranks.STEPS):
        for run in runs[1:]:
            assert torch.equal(run["steps"][i]["loss"], runs[0]["steps"][i]["loss"])


def test_remat_under_fsdp_gives_the_plain_step(ranks):
    """HRNet with ``remat`` under FSDP: the recompute runs the synchronised
    BatchNorm's all-reduce again in the backward, on every rank in the same
    order, and the step equals the plain one (float64: the same numbers,
    up to the order of the gradient's sums)."""
    mesh_shape, accum_steps = fsdp_ranks.REMAT_RUN[1:]
    plain = ranks["got"][0][fsdp_ranks.run_key("hrnet", mesh_shape, accum_steps)]["steps"]
    remat = ranks["got"][0][fsdp_ranks.run_key(*fsdp_ranks.REMAT_RUN)]["steps"]
    for p, r in zip(plain, remat):
        torch.testing.assert_close(r["loss"], p["loss"], rtol=1e-12, atol=0)
        for name, v in p["state"].items():
            torch.testing.assert_close(r["state"][name], v, rtol=1e-10, atol=1e-12)


def test_the_shard_dim_follows_fsdp_spec():
    """``fsdp_shard_dim`` is JAX's ``fsdp_spec`` shape rule as a dim."""
    from jax.sharding import PartitionSpec as P

    from mindpose_tpu.parallel.fsdp import fsdp_spec

    for shape in [(1024, 256), (256, 1024), (512, 512), (1023, 512), (1, 16, 12, 1280),
                  (100_003,), (64, 3, 8, 8)]:
        spec = fsdp_spec(shape, 4, min_size=1)
        want = None if spec == P() else next(i for i, s in enumerate(spec) if s is not None)
        assert fsdp_shard_dim(shape, 4) == want, shape
