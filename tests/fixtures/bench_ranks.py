"""Rank processes of the bench tool's data-parallel test, over gloo on the CPU.

``python -m tests.fixtures.bench_ranks train RANK WORLD PORT DIR`` (started
by ``ddp_ranks.start_ranks(..., module="tests.fixtures.bench_ranks")``):
each rank joins the group, loads the reduced HRNet of
tests/test_torch_hrnet.py that ``DIR/net.pt`` holds (``torch.save`` of the
module), and runs
``tools/bench.bench_train_step`` at ``batch_per_chip`` 2 in float32 (O0)
with that net; it writes each step's loss vector and the tool's report to
``DIR/train_rank{r}.pt``. This module imports torch and the port only,
never JAX.
"""
import sys


def _train_scenario(rank: int, world: int, port: int, out_dir: str) -> None:
    import os

    import torch

    from mindpose_tpu_torch.parallel import init_distributed
    from mindpose_tpu_torch.tools import bench

    torch.set_num_threads(1)
    net = torch.load(os.path.join(out_dir, "net.pt"), weights_only=False)
    losses = []
    build = bench.build_train_step

    def recording_build(*args, **kwargs):
        step = build(*args, **kwargs)

        def recorded(*batch):
            out = step(*batch)
            losses.append(out.detach().clone())
            return out

        return recorded

    bench.create_network = lambda *args, **kwargs: net
    bench.build_train_step = recording_build
    bench.AMP_LEVEL = "O0"
    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    report = bench.bench_train_step(batch_per_chip=2, iters=1, device=torch.device("cpu"))
    torch.save({"losses": losses, "report": report},
               os.path.join(out_dir, f"train_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


SCENARIOS = {"train": _train_scenario}

if __name__ == "__main__":
    scenario, rank, world, port, out_dir = sys.argv[1:6]
    SCENARIOS[scenario](int(rank), int(world), int(port), out_dir)
