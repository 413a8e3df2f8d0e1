"""Training CLI: config-driven training on one CUDA GPU, or data-parallel
with one process per card.

Counterpart of ``tools/train.py:61-517``, in its order: the config and CLI
overrides; the gate on divergent training knobs (``check_divergent_knobs``,
:62: ``backbone_setting.bn_grad_stats`` frozen or frozen_var, or
``optimizer_setting.radial_projection``, exit unless
``allow_divergent_knobs: true``, then one warning per knob); the process
group (:63-120); the global numpy seed
(``seed + rank``, :105);
the train and val datasets and loaders (:113-247); the net, its
pretrained backbone (``backbone_pretrained``, :270-280), the loss and
``NetWithLoss``; the schedule over ``len(loader_train)`` steps per epoch
and the optimizer; the resume from ``--ckpt`` (a port checkpoint or a JAX
package TrainState, :308); EMA; the inferencer and evaluator; the
``EvalCallback``; the epoch loop with ``StepTimer``; the wait for pending
checkpoint writes; and a crash checkpoint on any exception (:504-517).

The loader's batches are NHWC images and HWK targets (bottom-up:
[S, Hmax, Wmax, K] per record, with its mask and tag indices; SimCC's bin
labels [K, Bx+By] and regression's coordinates [K, 2], which pass as they
are), as the JAX loader gives them; they are uploaded (``device_prefetch: N``: from pinned
memory, N batches ahead) and turned to NCHW on the device (the joint axis
before the spatial ones), where the net and the loss take them.
``device_pipeline: true`` ships the crops and their keypoints instead
(bottom-up: the warped image, its per-level keypoints, mask and tag
indices), and the step renders the targets on the device.
``device_pipeline: full`` (top-down, :164-221) stops the host at the
decode: it ships uint8 source patches bucketed to ``image_bucket``
(default 64) with their warp matrices, and the step warps, normalizes and
renders; ``decode_cache_mb``, ``frame_grouped_shuffle`` and
``patch_grouped_batching`` pass to the loader. Bottom-up takes any truthy
``device_pipeline`` as ``true``, as the JAX entry does (:135).
``profile: true`` traces epoch 2 with ``torch.profiler`` into
``profile_dir`` (default ``<ckpt_save_dir>/trace``), stopping before the
epoch's evaluation and checkpoint (:476-483). An ``http(s)://``
``backbone_ckpt_url`` is downloaded, then loaded. Each epoch's record
also holds ``batch_bytes``, the bytes of the batches handed to the step
(uploaded, on the card), and the result the decoded-frame cache's hits
and misses. As in
the JAX entry, a resumed run counts its epochs from 1 while the step count,
and with it the schedule, continues.

Data-parallel: where the JAX entry runs one process per host with a mesh
over its chips, the port runs one process per card. Started by torchrun
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or with the ``MINDPOSE_COORDINATOR``/``MINDPOSE_NUM_PROCESSES``/
``MINDPOSE_PROCESS_ID`` variables of ``tools/launch_pod.py``, the entry
starts a process group (``nccl`` on CUDA, ``gloo`` with ``--device cpu``),
runs on ``cuda:LOCAL_RANK``, seeds numpy with ``seed + rank``, gives its
loader the records ``rank::world`` (``batch_size`` is per card, as in
JAX), trains through DDP with the BatchNorm statistics averaged
(``parallel/train.py``), evaluates and writes checkpoints and the crash
checkpoint on rank 0 alone, and logs the throughput of all ranks. A resume
reads the checkpoint on every rank. ``distributed_init: true`` requires
such a launch; ``distribute`` is accepted, as a mesh of one in JAX when
there is no group.

``parallel_mode: fsdp`` in a process group (:88-95, 340-359) shards the
net over the ``(data, model)`` mesh, ``model`` = ``model_parallel`` or the
world (``parallel/fsdp.py``), in this order: the net is built and restored
(the resume checkpoint, or a pretrained backbone) unsharded, then sharded;
the optimizer is built over the shards and takes the resumed state; EMA
starts from the sharded parameters. The BatchNorm statistics are the
global batch's, and rank 0 evaluates an unsharded copy of the net loaded
from the state that every rank gathers (``callbacks/eval_callback.py``);
the checkpoints are the files a single-device run writes. Without a
process group nothing is sharded, as the JAX entry's mesh of one, and
``model_parallel`` is not read, as JAX reads it only for an FSDP mesh.

``distill_setting`` (:311-333) builds the frozen teacher
(``models/distill.py``) and appends its heatmaps to each batch after the
base preprocess, for ``joint_mse_distill``.

The entry runs on the current CUDA device unless ``--device`` says
otherwise, and raises without CUDA, and with more than one visible card
outside a process group. It raises on a config key it does not read; it
ignores none.

Usage:
    python3 -m mindpose_tpu_torch.tools.train --config configs/hrnet/hrnet_w32_tpu.yaml \\
        [--device cpu] [--seed 0] [--ckpt resume.ckpt] [--cfg-options num_epochs=1 ...]
    torchrun --nproc_per_node=N -m mindpose_tpu_torch.tools.train --config ... [...]
    torchrun --nproc_per_node=N -m mindpose_tpu_torch.tools.train \\
        --config configs/vitpose/vitpose_h_tpu.yaml --cfg-options model_parallel=N [...]
"""
import logging
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..callbacks import EvalCallback
from ..config import check_divergent_knobs, parse_args
from ..data import create_dataset, create_pipeline
from ..data.column_names import FINAL_COLUMN_MAP
from ..data.device_pipeline import (
    BOTTOMUP_DEVICE_FINAL_COLUMNS,
    DEVICE_FINAL_COLUMNS,
    DEVICE_FULL_FINAL_COLUMNS,
    build_bottomup_preprocess,
    build_topdown_full_preprocess,
    build_topdown_preprocess,
    strip_host_target_transform,
    swap_bottomup_target_transform,
    to_matrix_transforms,
)
from ..data.loader import DevicePrefetcher
from ..engine import create_evaluator, create_inferencer
from ..models import (
    create_decoder,
    create_eval_network,
    create_loss,
    create_network,
    create_network_with_loss,
)
from ..optim import create_optimizer
from ..models.distill import build_teacher, build_teacher_preprocess
from ..parallel import (
    build_ema_update,
    build_train_step,
    create_mesh,
    init_distributed,
    is_distributed,
    shard_net,
)
from ..parallel.fsdp import load_optimizer_state, load_sharded, parameter_names
from ..scheduler import create_lr_scheduler
from ..utils.checkpoint import (
    load_ema,
    load_pretrained_backbone,
    restore_train_state,
    save_checkpoint,
    wait_pending_checkpoints,
)
from ..utils.misc import StepTimer
from ..utils.profiler import StepTraceContext, trace

__all__ = ["train", "check_config", "parse_train_args"]

# every key the JAX entry reads (tools/train.py), and the CLI's
KNOWN_KEYS = frozenset("""
    config ckpt seed device
    distribute distributed_init parallel_mode model_parallel allow_divergent_knobs
    dataset_format train_root train_label val_root val_label val_detection_result
    val_use_gt_bbox num_parallel_workers dataset_setting pipeline_method normalize_mean
    normalize_std train_transforms val_transforms device_pipeline image_bucket decode_cache_mb
    frame_grouped_shuffle patch_grouped_batching device_prefetch batch_size num_joints
    in_channels backbone_name backbone_setting backbone_pretrained backbone_ckpt_url neck_name
    neck_out_channels neck_setting head_name head_setting loss loss_with_extra_input
    loss_setting amp_level scheduler num_epochs lr warmup lr_scheduler_setting optimizer
    weight_decay filter_bias_and_bn optimizer_setting grad_accum_steps ema_decay
    distill_setting val_while_train val_interval save_best save_last ckpt_save_dir
    async_checkpoint inference_method eval_method eval_metric eval_setting decoder_name
    decoder_setting profile profile_dir
""".split())

PARALLEL_MODES = ("data", "fsdp")


def check_config(args: Any) -> None:
    """Raise on a key the entry does not read, or on an unknown parallel mode."""
    unknown = sorted(set(vars(args)) - KNOWN_KEYS)
    if unknown:
        raise ValueError(f"config keys the train entry does not read: {unknown}")
    parallel_mode = _parallel_mode(args)
    if parallel_mode not in PARALLEL_MODES:
        raise ValueError(f"unknown parallel_mode: {parallel_mode!r}")


def _parallel_mode(args: Any) -> str:
    return str(getattr(args, "parallel_mode", "data") or "data").lower()


def _distributed(args: Any) -> Tuple[int, int]:
    """Start the process group where the launch asks for one; ``(rank, world)``.

    Its backend follows ``--device``: nccl on CUDA (the default), gloo on
    the CPU."""
    rank, world = init_distributed(device=torch.device(getattr(args, "device", None)
                                                       or "cuda").type)
    if getattr(args, "distributed_init", False) and not is_distributed():
        raise ValueError(
            "distributed_init: true, and neither torchrun's RANK/WORLD_SIZE nor "
            "MINDPOSE_COORDINATOR is set: launch one process per card with `torchrun "
            "--nproc_per_node=N -m mindpose_tpu_torch.tools.train --config ...`")
    return rank, world


def _device(args: Any) -> torch.device:
    device = getattr(args, "device", None)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the train entry runs on the GPU by default, and CUDA is not "
                               "available; pass --device cpu to train on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and is_distributed():
        # init_distributed made cuda:LOCAL_RANK the current device
        return device if device.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise NotImplementedError(
            f"{n} CUDA devices are visible and no process group is initialised: the port "
            "trains data-parallel with one process per card, and one process does not drive "
            f"several. Launch one process per card (`torchrun --nproc_per_node={n} -m "
            "mindpose_tpu_torch.tools.train --config ...`), or make one card visible with "
            "CUDA_VISIBLE_DEVICES")
    return device


def train(args: Any) -> Dict[str, Any]:
    """Train as the config ``args`` says; returns what each epoch measured.

    The result: ``epochs``, one dict per epoch (``loss``, the epoch's mean
    summed loss; ``lr``; ``metrics``, the evaluation's, or {}; and the
    ``StepTimer`` summary, and ``batch_bytes``, the bytes of the epoch's
    batches), ``start_step`` and ``step``, the step counts at the start and
    at the end, ``pretrained_tensors``, the count of tensors a pretrained
    backbone gave (0 without one), and ``decode_cache``, the decoded-frame
    cache's ``hits`` and ``misses`` (None without one).
    """
    check_divergent_knobs(args)
    check_config(args)
    rank, world = _distributed(args)
    device = _device(args)
    seed = getattr(args, "seed", 0) or 0
    # host augmentations draw from the global numpy stream, one per rank
    np.random.seed(seed + rank)
    workers = getattr(args, "num_parallel_workers", 4)

    # ---- data: this rank's shard of the records, batch_size per card ----
    dataset_train = create_dataset(
        args.train_root, args.train_label, dataset_format=args.dataset_format, is_train=True,
        device_num=world, rank_id=rank, num_workers=workers, config=args.dataset_setting)
    device_pipeline = getattr(args, "device_pipeline", False)
    train_transforms = args.train_transforms
    preprocess = None
    final_columns = FINAL_COLUMN_MAP[args.pipeline_method]["train"]
    image_bucket = None
    if device_pipeline and args.pipeline_method == "bottomup":
        # the host stops at the warp and the tag indices; normalize and the
        # multi-level targets run in the step
        train_transforms, sigma = swap_bottomup_target_transform(train_transforms)
        preprocess = build_bottomup_preprocess(
            heatmap_sizes=args.dataset_setting["heatmap_sizes"],
            normalize_mean=args.normalize_mean, normalize_std=args.normalize_std, sigma=sigma)
        final_columns = BOTTOMUP_DEVICE_FINAL_COLUMNS
    elif device_pipeline:
        train_transforms, target_kwargs = strip_host_target_transform(train_transforms)
        pp_kwargs = dict(image_size=args.dataset_setting["image_size"],
                         heatmap_size=args.dataset_setting["heatmap_size"],
                         normalize_mean=args.normalize_mean, normalize_std=args.normalize_std,
                         **target_kwargs)
        if str(device_pipeline).lower() == "full":
            # the host stops at the decode; warp, normalize and targets run in the step
            train_transforms = to_matrix_transforms(train_transforms)
            preprocess = build_topdown_full_preprocess(**pp_kwargs)
            final_columns = DEVICE_FULL_FINAL_COLUMNS
            image_bucket = int(getattr(args, "image_bucket", 64) or 64)
        else:
            # the host stops at the affine crop; normalize and targets run in the step
            preprocess = build_topdown_preprocess(**pp_kwargs)
            final_columns = DEVICE_FINAL_COLUMNS
    loader_train = create_pipeline(
        dataset_train, transforms=train_transforms, method=args.pipeline_method,
        batch_size=args.batch_size, is_train=True, normalize=not device_pipeline,
        normalize_mean=args.normalize_mean, normalize_std=args.normalize_std,
        num_workers=workers, config=args.dataset_setting, seed=seed,
        final_columns=final_columns, image_bucket=image_bucket,
        decode_cache_mb=getattr(args, "decode_cache_mb", 0) or 0,
        frame_grouped_shuffle=bool(getattr(args, "frame_grouped_shuffle", False)),
        patch_grouped_batching=bool(getattr(args, "patch_grouped_batching", False)))

    val_while_train = getattr(args, "val_while_train", False)
    loader_val = None
    if val_while_train:
        dataset_val = create_dataset(
            args.val_root, args.val_label, dataset_format=args.dataset_format, is_train=False,
            use_gt_bbox_for_val=getattr(args, "val_use_gt_bbox", True),
            detection_file=getattr(args, "val_detection_result", None),
            num_workers=workers, config=args.dataset_setting)
        loader_val = create_pipeline(
            dataset_val, transforms=args.val_transforms, method=args.pipeline_method,
            batch_size=args.batch_size, is_train=False, normalize_mean=args.normalize_mean,
            normalize_std=args.normalize_std, num_workers=workers, config=args.dataset_setting)

    # ---- model ----
    def build_net() -> torch.nn.Module:
        return create_network(
            backbone_name=args.backbone_name, head_name=args.head_name,
            neck_name=getattr(args, "neck_name", "") or "",
            backbone_pretrained=getattr(args, "backbone_pretrained", False),
            backbone_ckpt_url=getattr(args, "backbone_ckpt_url", "") or "",
            in_channels=getattr(args, "in_channels", 3), num_joints=args.num_joints,
            backbone_args=getattr(args, "backbone_setting", None),
            head_args=getattr(args, "head_setting", None))

    torch.manual_seed(seed)
    net = build_net().to(device)
    # a local path, file:// or http(s):// (tools/train.py:270-280)
    pretrained_path = getattr(args, "backbone_ckpt_url", "") or ""
    pretrained_tensors = 0
    if getattr(args, "backbone_pretrained", False):
        if pretrained_path:
            pretrained_tensors = load_pretrained_backbone(pretrained_path, net)
        else:
            logging.warning("backbone_pretrained=True but backbone_ckpt_url is empty — "
                            "training from scratch")
    loss = create_loss(args.loss, **(getattr(args, "loss_setting", None) or {}))
    net_with_loss = create_network_with_loss(
        net, loss, has_extra_inputs=getattr(args, "loss_with_extra_input", False))

    # ---- lr scheduler + optimizer ----
    lr_scheduler = create_lr_scheduler(
        args.scheduler, lr=args.lr, total_epochs=args.num_epochs,
        steps_per_epoch=len(loader_train), warmup=getattr(args, "warmup", 0),
        **(getattr(args, "lr_scheduler_setting", None) or {}))

    def build_optimizer() -> torch.optim.Optimizer:
        return create_optimizer(
            net, name=args.optimizer, learning_rate=args.lr,
            weight_decay=getattr(args, "weight_decay", 0.0),
            filter_bias_and_bn=getattr(args, "filter_bias_and_bn", True),
            **(getattr(args, "optimizer_setting", None) or {}))

    optimizer = build_optimizer()

    # ---- resume ----
    ckpt = getattr(args, "ckpt", None)
    start_step = restore_train_state(ckpt, net, optimizer) if ckpt else 0

    # ---- FSDP: shard the restored net, then the optimizer over its shards ----
    sharded = _parallel_mode(args) == "fsdp" and is_distributed()
    if sharded:
        mesh = create_mesh(getattr(args, "model_parallel", None), device.type)
        resumed = optimizer.state_dict() if ckpt else None
        names = parameter_names(net, optimizer)
        shard_net(net, mesh)
        optimizer = build_optimizer()
        if resumed is not None:
            load_optimizer_state(net, optimizer, resumed, names)
        logging.info("fsdp: mesh %s", dict(zip(mesh.mesh_dim_names, mesh.shape)))

    # ---- distillation: the frozen teacher's heatmaps appended to each batch ----
    host_layout = preprocess is None  # the step takes the loader's columns, made NCHW
    distill_setting = getattr(args, "distill_setting", None)
    if distill_setting:
        teacher = build_teacher(distill_setting, num_joints=args.num_joints,
                                in_channels=getattr(args, "in_channels", 3), device=device)
        preprocess = build_teacher_preprocess(teacher, base_preprocess=preprocess)
        logging.info("distillation: teacher %s/%s from %s", distill_setting["teacher_backbone"],
                     distill_setting["teacher_head"], distill_setting["teacher_ckpt"])

    step_fn = build_train_step(
        net_with_loss, optimizer, lr_scheduler, preprocess=preprocess,
        accum_steps=int(getattr(args, "grad_accum_steps", 1) or 1),
        amp_level=getattr(args, "amp_level", "O0") or "O0", start_step=start_step)

    # ---- EMA: evaluation runs on the averaged parameters (sharded as the net) ----
    ema_decay = float(getattr(args, "ema_decay", 0.0) or 0.0)
    ema_params = ema_step = None
    if ema_decay:
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        ema_params = {n: p.detach().clone() for n, p in net.named_parameters()}
        if ckpt and os.path.exists(ckpt + ".ema"):
            load_sharded(ema_params, load_ema(ckpt + ".ema"))
            logging.info("resumed EMA params from %s", ckpt + ".ema")
        ema_step = build_ema_update(ema_decay)

    # ---- eval engines ----
    config_name = os.path.splitext(os.path.basename(args.config))[0]
    ckpt_dir = getattr(args, "ckpt_save_dir", "./ckpt")
    inferencer = evaluator = eval_copy = None
    if val_while_train:
        decoder = create_decoder(args.decoder_name, **(getattr(args, "decoder_setting", None)
                                                       or {}))
        # a sharded net runs only with every rank: rank 0 alone evaluates, an
        # unsharded copy loaded from the gathered state at each evaluation
        # (so built without initialising its weights); the other ranks hold
        # no copy and no inferencer
        if sharded and rank == 0:
            with torch.device("meta"):
                eval_copy = build_net()
            eval_copy = eval_copy.to_empty(device=device)
        if not sharded or rank == 0:
            eval_net = create_eval_network(
                eval_copy if sharded else net, decoder,
                output_raw=args.eval_setting.get("has_heatmap_output", True))
            inferencer = create_inferencer(
                eval_net, name=args.inference_method, config=args.eval_setting,
                dataset_config=args.dataset_setting, device=device,
                amp_level=getattr(args, "amp_level", "O0") or "O0")
            evaluator = create_evaluator(
                args.val_label, name=args.eval_method, metric=args.eval_metric,
                config=args.eval_setting, dataset_config=args.dataset_setting,
                num_joints=args.num_joints,
                result_path=os.path.join(ckpt_dir, "result_keypoints.json"))

    # ---- callback ----
    callback = EvalCallback(
        inferencer=inferencer, evaluator=evaluator, dataset_val=loader_val,
        interval=getattr(args, "val_interval", 1), max_epoch=args.num_epochs,
        save_best=getattr(args, "save_best", False), save_last=getattr(args, "save_last", False),
        best_ckpt_path=os.path.join(ckpt_dir, f"{config_name}_best.ckpt"),
        last_ckpt_path=os.path.join(ckpt_dir, f"{config_name}_last.ckpt"),
        target_metric_name=(args.eval_metric[0] if isinstance(args.eval_metric, list)
                            else args.eval_metric),
        summary_dir=os.path.join(ckpt_dir, "summary"), rank_id=rank, device_num=world,
        async_checkpoint=bool(getattr(args, "async_checkpoint", False)), eval_net=eval_copy)

    # ---- the train loop ----
    device_prefetch = int(getattr(args, "device_prefetch", 0) or 0)

    def device_batches():
        if device_prefetch:
            yield from DevicePrefetcher(loader_train, final_columns, device, depth=device_prefetch)
            return
        for batch in loader_train:
            yield [torch.from_numpy(np.ascontiguousarray(batch[c])).to(device)
                   for c in final_columns]

    def step_inputs(arrays: List[torch.Tensor]) -> List[torch.Tensor]:
        if not host_layout:  # the device preprocess takes NHWC crops itself
            return arrays
        image, target, *extra = arrays
        image = image.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        if target.dim() == 3:  # SimCC [N, K, Bx+By] or regression [N, K, 2]: as they are
            return [image, target, *extra]
        # the joint axis before the spatial ones: NHWK -> NKHW (top-down),
        # N S H W K -> N S K H W (bottom-up, whose mask and tag_ind pass as they are)
        order = (0, 3, 1, 2) if target.dim() == 4 else (0, 1, 4, 2, 3)
        return [image, target.permute(*order).contiguous(), *extra]

    profile = bool(getattr(args, "profile", False))
    profile_dir = getattr(args, "profile_dir", None) or os.path.join(ckpt_dir, "trace")
    epochs = []
    try:
        for epoch in range(1, args.num_epochs + 1):
            timer = StepTimer()  # per epoch: the first includes cuDNN's autotuning
            batch_bytes = 0
            callback.on_epoch_begin(epoch)
            # profile epoch 2 (the first holds cuDNN's autotuning); the trace
            # stops before the evaluation and the checkpoint
            with trace(profile_dir, enabled=profile and epoch == 2, device=device):
                batches = iter(device_batches())
                while True:
                    timer.start()
                    try:
                        arrays = next(batches)
                    except StopIteration:
                        break
                    timer.loaded()
                    batch_bytes += sum(a.numel() * a.element_size() for a in arrays)
                    with StepTraceContext("train", step_fn.count):
                        loss_vec = step_fn(*step_inputs(arrays))
                    if ema_step is not None:
                        ema_step(ema_params, dict(net.named_parameters()))
                    callback.on_step_end(loss_vec)
                    timer.stop(arrays[0].shape[0])
            lr_now = lr_scheduler(step_fn.count)
            metrics = callback.on_epoch_end(epoch, net, optimizer, step_fn.count, lr_now,
                                            ema_params=ema_params)
            epochs.append(dict(timer.summary(), epoch=epoch, loss=callback.loss_meter.avg,
                               lr=lr_now, metrics=metrics, batch_bytes=batch_bytes))
            logging.info("throughput: %.1f images/sec (%.1f/card)",
                         timer.images_per_sec * world, timer.images_per_sec)
        wait_pending_checkpoints()
    except BaseException:
        # persist the last state before the exception propagates (rank 0: the
        # replicas are equal). A sharded state needs every rank to gather it,
        # and the others may not come: as in JAX, whose rank 0 cannot write a
        # state sharded over processes, it is not written.
        if rank == 0 and sharded:
            logging.error("no crash checkpoint: the state is sharded over the ranks")
        elif rank == 0:
            crash_path = os.path.join(ckpt_dir, f"{config_name}_crash.ckpt")
            try:
                save_checkpoint(crash_path, net, optimizer, step_fn.count)
                logging.error("crash checkpoint saved to %s", crash_path)
            except Exception:
                logging.exception("failed to save crash checkpoint")
        raise
    cache = loader_train.decode_cache
    return {"epochs": epochs, "start_step": start_step, "step": step_fn.count,
            "pretrained_tensors": pretrained_tensors,
            "decode_cache": {"hits": cache.hits, "misses": cache.misses} if cache else None}


def parse_train_args(argv=None) -> Any:
    """The CLI's arguments: the config with its overrides, ``--seed`` and ``--device``."""
    return parse_args(argv, description="mindpose_tpu_torch training", extra_args=[
        {"names": ["--seed"], "type": int, "default": None, "help": "random seed"},
        {"names": ["--device"], "default": None,
         "help": "where the net trains (default: the current CUDA device)"}])


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    try:
        train(parse_train_args())
    finally:
        if is_distributed():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
