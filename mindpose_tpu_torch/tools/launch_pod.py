"""Multi-host training launcher: run one copy per host.

Counterpart of the JAX package's ``tools/launch_pod.py``:

- dataset preparation runs on process 0 only, behind a file barrier on a
  shared filesystem that stores a hash of the command
  (``prepare_data_rank0``, a copy of the original's);
- the host's rank and the job's size come from ``PROCESS_ID``,
  ``NUM_PROCESSES`` and ``COORDINATOR_ADDRESS`` (``host:port``), and the
  launcher refuses to guess rank 0 when ``NUM_PROCESSES > 1``, as the
  original does (there is no ``TPU_WORKER_ID`` here);
- the launch differs: the port runs one process per card, so each host
  starts the train entry under ``torchrun --nnodes NUM_PROCESSES
  --node_rank PROCESS_ID --nproc_per_node <the host's cards, or
  --nproc-per-node>`` with the coordinator as torchrun's master. The entry
  reads torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``
  (``parallel/mesh.init_distributed``). With one host and no coordinator
  it is ``torchrun --standalone``.

Usage (``--`` ends the launcher's flags; the rest go to the train entry):
    PROCESS_ID=0 NUM_PROCESSES=2 COORDINATOR_ADDRESS=10.0.0.1:29500 \\
        python3 -m mindpose_tpu_torch.tools.launch_pod --config <cfg.yaml> \\
        [--prepare-cmd "..."] [--workdir /shared] [--nproc-per-node N] \\
        -- --cfg-options num_epochs=1
"""
import argparse
import hashlib
import logging
import os
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["prepare_data_rank0", "host_rank", "torchrun_command", "main"]

_BARRIER = ".mindpose_data_ready"
TRAIN_ENTRY = "mindpose_tpu_torch.tools.train"  # the module torchrun runs on each rank


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def prepare_data_rank0(prepare_cmd: str, workdir: str, rank: int,
                       timeout_s: int = 3600) -> None:
    """Run the data-preparation command on rank 0; other ranks wait on a
    file barrier.

    The barrier stores a hash of ``prepare_cmd`` so a stale barrier from a
    previous launch only satisfies waiters when it corresponds to the same
    (successfully completed) preparation; a changed command makes ranks>0
    wait for rank 0 to re-run it and rewrite the barrier.
    """
    barrier = os.path.join(workdir, _BARRIER)
    stamp = hashlib.sha256(prepare_cmd.encode()).hexdigest()

    def _barrier_ok():
        try:
            with open(barrier) as f:
                return f.read().strip() == stamp
        except OSError:
            return False

    if rank == 0:
        if _barrier_ok():
            logging.info("[rank 0] data already prepared (barrier matches)")
            return
        if os.path.exists(barrier):
            os.remove(barrier)  # stale barrier from a different prepare-cmd
        logging.info("[rank 0] preparing data: %s", prepare_cmd)
        subprocess.run(prepare_cmd, shell=True, check=True)
        with open(barrier, "w") as f:
            f.write(stamp)
        return
    logging.info("[rank %d] waiting for rank 0 data preparation...", rank)
    t0 = time.time()
    while not _barrier_ok():
        if time.time() - t0 > timeout_s:
            raise TimeoutError("data preparation barrier timed out")
        time.sleep(5)


def host_rank(parser: argparse.ArgumentParser) -> tuple:
    """(rank, number of hosts, coordinator) from the environment. A missing
    ``PROCESS_ID`` is rank 0 only in a job of one host: with NUM_PROCESSES > 1
    a guessed rank 0 on every host would run the preparation concurrently and
    start duplicate node ranks."""
    rank = _env_int("PROCESS_ID")
    world = _env_int("NUM_PROCESSES")
    coord = os.environ.get("COORDINATOR_ADDRESS") or None
    if rank is None:
        if world and world > 1:
            parser.error(
                "cannot determine this host's rank: set PROCESS_ID. With "
                "NUM_PROCESSES > 1 a guessed rank 0 on every host would run "
                "--prepare-cmd concurrently and give torchrun duplicate node ranks."
            )
        rank = 0
    if world and world > 1 and not coord:
        parser.error("NUM_PROCESSES > 1 needs COORDINATOR_ADDRESS (host:port of rank 0's host)")
    return rank, world or 1, coord


def _cards() -> int:
    import torch

    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device on this host: pass --nproc-per-node "
                           "(and --device cpu to the train entry) to train on the CPU")
    return count


def torchrun_command(config: str, train_args: List[str], rank: int, hosts: int,
                     coordinator: Optional[str], nproc_per_node: int,
                     entry: str = TRAIN_ENTRY) -> List[str]:
    """The torchrun command line that starts this host's ranks of ``entry``."""
    cmd = [sys.executable, "-m", "torch.distributed.run"]
    if coordinator:
        host, port = coordinator.rsplit(":", 1)
        cmd += ["--nnodes", str(hosts), "--node_rank", str(rank),
                "--master_addr", host, "--master_port", port]
    else:
        cmd += ["--standalone", "--nnodes", "1"]
    return cmd + ["--nproc_per_node", str(nproc_per_node), "-m", entry,
                  "--config", config, *train_args]


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser(
        description="mindpose_tpu_torch multi-host launcher (one copy per host)"
    )
    parser.add_argument("--config", required=True)
    parser.add_argument(
        "--prepare-cmd", default="",
        help="shell command run once on rank 0 before training "
             "(dataset download/extraction), guarded by a file barrier",
    )
    parser.add_argument(
        "--workdir", default=".",
        help="shared filesystem directory for the barrier file",
    )
    parser.add_argument("--nproc-per-node", type=int, default=None,
                        help="processes on this host (default: its CUDA devices)")
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="extra args forwarded to the train entry")
    args = parser.parse_args(argv)
    rank, hosts, coordinator = host_rank(parser)

    if args.prepare_cmd:
        prepare_data_rank0(args.prepare_cmd, args.workdir, rank)

    extra = list(args.train_args)
    if extra and extra[0] == "--":
        extra = extra[1:]
    nproc = args.nproc_per_node or _cards()
    cmd = torchrun_command(args.config, extra, rank, hosts, coordinator, nproc, TRAIN_ENTRY)
    # the entry takes its process group from torchrun's variables alone
    env = {k: v for k, v in os.environ.items() if not k.startswith("MINDPOSE_")
           or k == "MINDPOSE_NATIVE"}
    logging.info("[host %d of %d] exec: %s", rank, hosts, " ".join(cmd))
    os.execve(sys.executable, cmd, env)


if __name__ == "__main__":
    main()
