"""Rank processes of the port's data-parallel tests, over gloo on the CPU.

``start_ranks`` starts one fresh interpreter per rank
(``python -m tests.fixtures.ddp_ranks SCENARIO RANK WORLD PORT DIR``), never
a fork of a test worker that has JAX and XLA threads loaded; the ranks have
a timeout, and the group is killed when one fails (``run_processes``, which
chip_smoke.py's phase 26 uses too). A scenario reads its
inputs from ``DIR`` and writes its results there, for the test to assert
on. This module imports torch and the port only, never JAX.

Scenarios:

- ``step`` (4 ranks): the reduced HRNet's step through ``build_train_step``
  in the process group, in float64, rank *i* given the *i*-th quarter of
  the global batch, 3 steps at ``accum_steps`` 1 and at 2, each from the
  same start (``step_rank{r}.pt``: each step's loss vector and the
  state_dict after it); the same step in float32 at world 2 in the
  subgroup of ranks 0 and 1, each given half of the batch
  (``world2_rank{r}.pt``); and ``allreduce_mean``,
  ``gather_records`` and ``is_main_process`` (``collectives_rank{r}.json``).
- ``entry`` (2 ranks): the train entry on ``argv.json``'s arguments,
  launched as ``tools/launch_pod.py`` launches it (the ``MINDPOSE_*``
  variables), one epoch with the callback evaluating; rank 0 then runs the
  eval entry on the last checkpoint; then a run whose callback raises after
  the second step (``entry_rank{r}.json``, ``entry_final_rank{r}.pt``).
"""
import copy
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEPS = 3
ACCUM_STEPS = (1, 2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def run_processes(commands: List[list], logs: List[str], timeout: float, label: str,
                  env=None) -> List[str]:
    """Run each command as a fresh process in its own session, its output to
    its log; returns the outputs.

    Raises as soon as one fails, or when one outlives ``timeout`` seconds;
    every process still running is then killed with its session (a rank left
    waiting in a collective would wait for the group's timeout)."""
    procs = []
    for command, log in zip(commands, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(command, cwd=ROOT, env=env, stdout=out,
                                          stderr=subprocess.STDOUT, start_new_session=True))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                failed = f"a process outlived {timeout} s"
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    outputs = []
    for log in logs:
        with open(log) as f:
            outputs.append(f.read())
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed or bad:
        i = bad[0] if bad else 0
        raise RuntimeError(f"{label}: {failed or f'process {i} exited {procs[i].returncode}'}:"
                           f"\n{outputs[i][-6000:]}")
    return outputs


def start_ranks(scenario: str, world: int, out_dir: str, timeout: float = 900.0,
                module: str = "tests.fixtures.ddp_ranks") -> List[str]:
    """Run ``scenario`` of ``module`` (this one, or a sibling with the same
    command line) in ``world`` rank processes (``run_processes``); returns
    their output."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    port = free_port()
    commands = [[sys.executable, "-m", module, scenario, str(rank),
                 str(world), str(port), out_dir] for rank in range(world)]
    logs = [os.path.join(out_dir, f"{scenario}_rank{rank}.log") for rank in range(world)]
    return run_processes(commands, logs, timeout, scenario, env)


# ------------------------------------------------------------- the scenarios


def _step_scenario(rank: int, world: int, port: int, out_dir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from mindpose_tpu_torch.data.device_pipeline import build_topdown_preprocess
    from mindpose_tpu_torch.models import create_loss, create_network_with_loss
    from mindpose_tpu_torch.optim import create_optimizer
    from mindpose_tpu_torch.parallel import (
        build_train_step,
        gather_records,
        init_distributed,
        is_main_process,
    )
    from mindpose_tpu_torch.scheduler import create_lr_scheduler
    from mindpose_tpu_torch.utils.misc import allreduce_mean

    assert init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") == (rank, world)
    with open(os.path.join(out_dir, "setup.json")) as f:
        setup = json.load(f)
    start = torch.load(os.path.join(out_dir, "net.pt"), weights_only=False)
    batch = np.load(os.path.join(out_dir, "batch.npz"))
    image, kpts = torch.from_numpy(batch["image"]), torch.from_numpy(batch["keypoints"])

    def run(group, parts: int, index: int, accum_steps: int, dtype: torch.dtype) -> list:
        net = copy.deepcopy(start["net"])  # a fresh replica, and a fresh DDP over it
        net.load_state_dict(start["state"])
        net.to(dtype)
        nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                       has_extra_inputs=True)
        render = build_topdown_preprocess(**setup["preprocess"])

        def preprocess(*batch):  # crops and targets in the net's dtype
            return tuple(t.to(dtype) for t in render(*batch))

        step = build_train_step(
            nwl, create_optimizer(net, **setup["optimizer"]),
            create_lr_scheduler("warmup_multi_step_decay", **setup["schedule"]),
            preprocess=preprocess, accum_steps=accum_steps, process_group=group)
        assert isinstance(step.module, torch.nn.parallel.DistributedDataParallel)
        n = image.shape[0] // parts
        shard = slice(index * n, (index + 1) * n)
        steps = []
        for _ in range(STEPS):
            loss = step(image[shard], kpts[shard])
            steps.append({"loss": loss.clone(),
                          "state": {k: v.clone() for k, v in net.state_dict().items()}})
        return steps

    torch.save({f"accum{a}": run(None, world, rank, a, torch.float64) for a in ACCUM_STEPS},
               os.path.join(out_dir, f"step_rank{rank}.pt"))
    pair = dist.new_group([0, 1])  # every rank takes part in making it
    if rank < 2:
        torch.save(run(pair, 2, rank, 1, torch.float32),
                   os.path.join(out_dir, f"world2_rank{rank}.pt"))
    mean = allreduce_mean(np.array([rank, 2.0 * rank], np.float32))
    records = gather_records([{"rank": rank, "pred": np.arange(rank + 1)}])
    with open(os.path.join(out_dir, f"collectives_rank{rank}.json"), "w") as f:
        json.dump({"mean": mean.tolist(), "mean_dtype": str(mean.dtype),
                   "records": [{"rank": r["rank"], "pred": np.asarray(r["pred"]).tolist(),
                                "pred_is_array": isinstance(r["pred"], np.ndarray)}
                               for r in records],
                   "main": is_main_process()}, f)
    dist.barrier()
    dist.destroy_process_group()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _entry_scenario(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from mindpose_tpu_torch.callbacks import eval_callback
    from mindpose_tpu_torch.tools import eval as port_eval
    from mindpose_tpu_torch.tools import train as port_train
    from mindpose_tpu_torch.utils.checkpoint import load_checkpoint
    from tests.fixtures.eval_checks import (
        compare_callback_with_eval_entry,
        recording_entry,
        register_port_backbone,
    )

    # tools/launch_pod.py's variables
    os.environ.update(MINDPOSE_COORDINATOR=f"127.0.0.1:{port}",
                      MINDPOSE_NUM_PROCESSES=str(world), MINDPOSE_PROCESS_ID=str(rank))
    register_port_backbone()
    with open(os.path.join(out_dir, "argv.json")) as f:
        argv = json.load(f)
    lines = _Lines()
    logging.getLogger().addHandler(lines)
    logging.getLogger().setLevel(logging.INFO)
    saves = []  # (where, path) of each checkpoint this rank wrote
    callback_save, entry_save = eval_callback.save_checkpoint, port_train.save_checkpoint

    def recorded(where, save):
        def wrapper(path, *args, **kwargs):
            saves.append((where, os.path.basename(path)))
            return save(path, *args, **kwargs)
        return wrapper

    eval_callback.save_checkpoint = recorded("callback", callback_save)
    port_train.save_checkpoint = recorded("crash", entry_save)

    args = port_train.parse_train_args(argv["train"])
    with recording_entry(port_train) as seen:
        result = port_train.train(args)
    net = seen["net"]
    torch.save({k: v.clone() for k, v in net.state_dict().items()},
               os.path.join(out_dir, f"entry_final_rank{rank}.pt"))
    record = {"rank": rank, "world": dist.get_world_size(), "epochs": result["epochs"],
              "step": result["step"], "evaluations": len(seen["outputs"]),
              "epoch_lines": [line for line in lines.lines
                              if line.startswith("epoch: [") and "loss:" in line]}
    if rank == 0:
        eval_args = port_train.parse_train_args(argv["eval"])
        ckpt = os.path.join(argv["ckpt_dir"], f"{argv['config_name']}_last.ckpt")
        eval_args.ckpt = ckpt
        eval_args.result_path = os.path.join(out_dir, "result.json")
        with recording_entry(port_eval) as evaluated:
            stats = port_eval.evaluate(eval_args, device="cpu")
        record["eval_entry_stats"] = {k: float(v) for k, v in stats.items()}
        record["same"] = compare_callback_with_eval_entry(seen, evaluated,
                                                          load_checkpoint(ckpt))
    dist.barrier()

    class FailingCallback(port_train.EvalCallback):
        def on_step_end(self, loss_vector):
            super().on_step_end(loss_vector)
            if len(self._loss_vectors) == 2:
                raise RuntimeError("injected")

    port_train.EvalCallback = FailingCallback
    saves_before = len(saves)
    try:
        port_train.train(port_train.parse_train_args(argv["crash"]))
        record["crash"] = "no exception"
    except RuntimeError as e:
        record["crash"] = str(e)
    record["saves"] = saves[:saves_before]
    record["crash_saves"] = saves[saves_before:]
    with open(os.path.join(out_dir, f"entry_rank{rank}.json"), "w") as f:
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
