"""The process group: bootstrap, rank-0 gating and the gather of records.

Counterpart of ``mindpose_tpu/parallel/mesh.py``. The JAX package runs one
process per host with a mesh over its local chips; the port runs one
process per card, started by ``torchrun`` or with the ``MINDPOSE_*``
variables that ``tools/launch_pod.py`` sets, and ``torch.distributed``'s
process group takes the place of ``jax.distributed``. The backend follows
the device the caller names: ``nccl`` for CUDA, ``gloo`` for the CPU; there
is no fallback from one to the other.

``create_mesh`` builds the 2-D ``(data, model)`` ``DeviceMesh`` that
``parallel_mode: fsdp`` shards over (``parallel/fsdp.py``), sized as the
JAX entry sizes its mesh (``tools/train.py:89-90``). ``data_sharding`` and
``replicated_sharding`` have no counterpart: ``DistributedDataParallel``
keeps a full replica on each rank (``parallel/train.py``), FSDP places its
own shards, and each rank's loader feeds the rank its own shard of the
records (``data/loader.py``), so there is no batch sharding spec.
"""
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "create_mesh",
    "init_distributed",
    "is_distributed",
    "local_device_count",
    "is_main_process",
    "gather_records",
]

# The other ranks wait in a collective while rank 0 evaluates: the timeout
# must cover one evaluation.
TIMEOUT = datetime.timedelta(hours=2)
DATA_AXIS = "data"
MODEL_AXIS = "model"


def is_distributed() -> bool:
    """True once a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> Tuple[int, int]:
    """Start the process group if asked; returns ``(rank, world_size)``.

    The group comes from the arguments (``coordinator_address`` as
    ``host:port``), else from ``MINDPOSE_COORDINATOR`` /
    ``MINDPOSE_NUM_PROCESSES`` / ``MINDPOSE_PROCESS_ID`` (the JAX entry's,
    ``tools/train.py:67-74``), else from torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``. Without any of them
    the run is one process: ``(0, 1)``, and no group. An initialised group
    is taken as it is. ``device`` ("cuda" or "cpu") picks the backend,
    ``nccl`` or ``gloo``; on CUDA the current device becomes
    ``cuda:LOCAL_RANK`` (without torchrun, the rank modulo the visible
    devices).
    """
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a process group runs on cuda (nccl) or the cpu (gloo), not {device!r}")
    env = os.environ
    if coordinator_address is None and env.get("MINDPOSE_COORDINATOR"):
        coordinator_address = env["MINDPOSE_COORDINATOR"]
        num_processes = int(env["MINDPOSE_NUM_PROCESSES"])
        process_id = int(env["MINDPOSE_PROCESS_ID"])
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    elif "WORLD_SIZE" in env and "RANK" in env:
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        return 0, 1
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an nccl process group needs CUDA, and CUDA is not available")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method=init_method,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return rank, world


def local_device_count() -> int:
    """The cards of this host, one process each: torchrun's
    ``LOCAL_WORLD_SIZE``, else the visible CUDA devices (1 without CUDA)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return max(torch.cuda.device_count(), 1)


def is_main_process() -> bool:
    """Rank-0 gating for evaluation, checkpoints and logs."""
    return not is_distributed() or dist.get_rank() == 0


def gather_records(records: list) -> list:
    """Every rank's list of records, concatenated in rank order, on every rank.

    One process: the list itself. The records travel pickled
    (``all_gather_object``), so numpy arrays come back as arrays, where the
    JAX package's JSON payload turns them into lists.
    """
    if not is_distributed() or dist.get_world_size() == 1:
        return records
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, records)
    return [r for part in gathered for r in part]


def create_mesh(model_parallel: Optional[int] = None, device: str = "cuda"):
    """The ``(data, model)`` ``DeviceMesh`` over every rank of the group.

    ``model`` is ``model_parallel`` or, where that is 0 or None, the world
    size, and ``data`` the world size over it, as the JAX entry sizes its
    FSDP mesh (``tools/train.py:89-90``); a ``model`` that does not divide
    the world raises. ``device`` is the mesh's device type, ``cuda`` or
    ``cpu``. Every rank calls it: it makes a process group per axis.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not is_distributed():
        raise RuntimeError("a device mesh needs an initialised process group")
    world = dist.get_world_size()
    model = int(model_parallel or 0) or world
    if model < 1 or world % model:
        raise ValueError(f"model_parallel={model} does not divide the {world} ranks")
    return init_device_mesh(torch.device(device).type, (world // model, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
