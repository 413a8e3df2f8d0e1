"""Rank processes of the port's FSDP tests, over gloo on the CPU.

Started as ``tests/fixtures/ddp_ranks.py`` starts DDP's ranks
(``ddp_ranks.start_ranks(..., module="tests.fixtures.fsdp_ranks")``): one
fresh interpreter per rank, a timeout, the group killed when one fails. A
scenario reads its inputs from ``DIR`` and writes its results there. This
module imports torch and the port only, never JAX.

Scenarios:

- ``step`` (4 ranks): on the ``(data, model)`` meshes ``MESHES`` and at
  ``accum_steps`` 1 and 2, ``STEPS`` float64 AdamW steps of two nets
  sharded by ``parallel/fsdp.shard_net``: the tiny ViTPose net (``vit.pt``,
  batch ``vit_batch.npz``) and the reduced HRNet with BatchNorm
  (``hrnet.pt``, raw crops and keypoints ``hrnet_batch.npz`` rendered by
  the device preprocess), each from the same start. Rank *r* takes its
  slice of each microbatch of the global batch (``rank_rows``), so that
  microbatch *i* of all ranks together is the global batch's microbatch *i*,
  as JAX's FSDP step splits it. Also the HRNet with ``remat`` on one mesh.
  Per run: each step's loss vector on every rank, the net gathered by
  ``full_state`` after each step (rank 0), each parameter's and each AdamW
  moment's local and full sizes, and whether a fresh sharded optimizer
  that loads the gathered optimizer state holds this rank's moments bit for
  bit (``fsdp_rank{r}.pt``).
- ``entry`` (4 ranks): the train entry on each run of ``argv.json``
  (name to arguments: ``parallel_mode: fsdp``, ``model_parallel: 2``), one
  after another in the process group the first starts from the
  ``MINDPOSE_*`` variables; after each, every rank gathers the trained net
  (``{run}_rank{r}.json``, ``{run}_gathered.pt`` from rank 0).
"""
import copy
import json
import logging
import os
import sys

import numpy as np

STEPS = 3
ACCUM_STEPS = (1, 2)
MESHES = ((1, 4), (2, 2))  # (data, model)
REMAT_RUN = ("hrnet_remat", (2, 2), 2)


def rank_rows(batch: int, world: int, accum_steps: int, rank: int) -> list:
    """The rows of the global batch that ``rank`` takes: its slice of each of
    the ``accum_steps`` microbatches, in order."""
    micro = batch // accum_steps
    per = micro // world
    return [i * micro + rank * per + j for i in range(accum_steps) for j in range(per)]


def run_key(net: str, mesh, accum_steps: int) -> str:
    return f"{net}-{mesh[0]}x{mesh[1]}-accum{accum_steps}"


def _step_scenario(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
    from mindpose_tpu_torch.models import create_loss, create_network_with_loss
    from mindpose_tpu_torch.models.backbones.hrnet import HRModule
    from mindpose_tpu_torch.optim import create_optimizer
    from mindpose_tpu_torch.parallel import (
        build_train_step,
        create_mesh,
        full_state,
        init_distributed,
        shard_net,
    )
    from mindpose_tpu_torch.parallel.fsdp import load_optimizer_state, parameter_names

    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
    with open(os.path.join(out_dir, "setup.json")) as f:
        setup = json.load(f)
    meshes = {shape: create_mesh(shape[1], "cpu") for shape in MESHES}
    nets = {name: torch.load(os.path.join(out_dir, f"{name}.pt"), weights_only=False)
            for name in ("vit", "hrnet")}
    vit_batch = {k: torch.from_numpy(v) for k, v in
                 np.load(os.path.join(out_dir, "vit_batch.npz")).items()}
    hrnet_batch = {k: torch.from_numpy(v) for k, v in
                   np.load(os.path.join(out_dir, "hrnet_batch.npz")).items()}
    render = build_topdown_preprocess(**setup["preprocess"])

    def local(tensor, accum_steps):
        return tensor[rank_rows(tensor.shape[0], world, accum_steps, rank)]

    def run(name, mesh_shape, accum_steps):
        start = nets["hrnet" if name.startswith("hrnet") else "vit"]
        net = copy.deepcopy(start["net"])
        net.load_state_dict(start["state"])
        if name == "hrnet_remat":
            for m in net.modules():
                if isinstance(m, HRModule):
                    m.remat = True
        net.double()
        shard_net(net, meshes[mesh_shape])
        nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                       has_extra_inputs=True)
        optimizer = create_optimizer(net, **setup["optimizer"])
        preprocess = None
        if name == "vit":
            batch = [local(vit_batch[k], accum_steps) for k in ("image", "target", "weight")]
        else:
            batch = [local(hrnet_batch[k], accum_steps) for k in ("image", "keypoints")]

            def preprocess(*cols):  # crops and targets in float64
                return tuple(t.double() for t in render(*cols))

        step = build_train_step(nwl, optimizer, preprocess=preprocess, accum_steps=accum_steps)
        assert step.module is nwl
        steps = []
        for _ in range(STEPS):
            loss = step(*batch)
            state, _, _ = full_state(net)
            steps.append({"loss": loss.clone(), "state": state})
        sizes = {n: (p.to_local().numel(), p.numel()) for n, p in net.named_parameters()
                 if isinstance(p, DTensor)}
        moments = {}
        for n, p in net.named_parameters():
            s = optimizer.state[p]
            moments[n] = (s["exp_avg"].to_local().numel(), s["exp_avg_sq"].to_local().numel())
        # the gathered optimizer state, loaded into a fresh sharded optimizer
        _, gathered, _ = full_state(net, optimizer)
        box = [gathered]
        dist.broadcast_object_list(box, src=0)
        fresh = create_optimizer(net, **setup["optimizer"])
        for p in net.parameters():
            p.grad = None
        load_optimizer_state(net, fresh, box[0], parameter_names(net, optimizer))
        reloaded = all(
            torch.equal(fresh.state[p][k].to_local(), optimizer.state[p][k].to_local())
            for p in net.parameters() for k in ("exp_avg", "exp_avg_sq"))
        return {"steps": steps, "sizes": sizes, "moments": moments, "reloaded": reloaded}

    results = {}
    for mesh_shape in MESHES:
        for accum_steps in ACCUM_STEPS:
            for name in ("vit", "hrnet"):
                results[run_key(name, mesh_shape, accum_steps)] = run(name, mesh_shape,
                                                                      accum_steps)
    results[run_key(*REMAT_RUN)] = run(*REMAT_RUN)
    torch.save(results, os.path.join(out_dir, f"fsdp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _entry_scenario(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from mindpose_tpu_torch.parallel import full_state
    from mindpose_tpu_torch.tools import train as port_train
    from tests.fixtures.ddp_ranks import _Lines
    from tests.fixtures.eval_checks import recording_entry, register_port_backbone

    os.environ.update(MINDPOSE_COORDINATOR=f"127.0.0.1:{port}",
                      MINDPOSE_NUM_PROCESSES=str(world), MINDPOSE_PROCESS_ID=str(rank))
    register_port_backbone()
    with open(os.path.join(out_dir, "argv.json")) as f:
        runs = json.load(f)
    lines = _Lines()
    logging.getLogger().addHandler(lines)
    logging.getLogger().setLevel(logging.INFO)
    nets = []
    make_net = port_train.create_network

    def create_network(*args, **kwargs):
        nets.append(make_net(*args, **kwargs))
        return nets[-1]

    port_train.create_network = create_network
    for run, argv in runs.items():  # one after another, in the one process group
        nets.clear()
        lines.lines.clear()
        with recording_entry(port_train) as seen:
            result = port_train.train(port_train.parse_train_args(argv))
        trained = nets[0]  # the sharded net; nets[1], if any, is rank 0's eval copy
        gathered, _, _ = full_state(trained)
        shards = {n: [p.to_local().numel(), p.numel()] for n, p in trained.named_parameters()}
        record = {"rank": rank, "world": dist.get_world_size(), "epochs": result["epochs"],
                  "step": result["step"], "start_step": result["start_step"],
                  "evaluations": len(seen["outputs"]), "nets": len(nets), "shards": shards,
                  "mesh_lines": [line for line in lines.lines
                                 if line.startswith("fsdp: mesh")]}
        if rank == 0:
            torch.save(gathered, os.path.join(out_dir, f"{run}_gathered.pt"))
            if len(nets) > 1:
                copy_state = nets[1].state_dict()
                record["copy_is_gathered"] = set(copy_state) == set(gathered) and all(
                    torch.equal(v, gathered[k]) for k, v in copy_state.items())
        with open(os.path.join(out_dir, f"{run}_rank{rank}.json"), "w") as f:
            json.dump(record, f, default=float)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    scenario, rank, world, port, out_dir = sys.argv[1:]
    import torch

    torch.set_num_threads(1)  # the test machine already runs one worker per core
    {"step": _step_scenario, "entry": _entry_scenario}[scenario](
        int(rank), int(world), int(port), out_dir)


if __name__ == "__main__":
    main()
