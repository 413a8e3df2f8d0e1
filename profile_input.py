#!/usr/bin/env python3
"""What each training input mode costs the train entry, on one CUDA GPU.

Usage (from the root of a checkout, on the machine chip_smoke.py runs on):

    python3 profile_input.py [--epochs 3] [--warmup 5] [--repeat 1] \
        [--variants "full + all,true"] [--out profile_input.json]

It writes chip_smoke.py phase 12's synthetic COCO (640 frames of 360x480,
1,280 persons; 64 val frames) and trains hrnet_w32_tpu.yaml as parsed
(full-width HRNet-W32, O2, batch 128, adamw, ``--warmup`` steps, random
weights from torch's seed) through ``tools/train.train`` for ``--epochs``
epochs of 10 steps each, evaluating after the last, ``--repeat`` times per
variant, in this order (``--variants`` picks some by name):
``device_pipeline: true``; ``full`` with ``image_bucket`` 64 alone; full
with the decode cache and frame-grouped shuffling; full with
patch-grouped batching; full with all three; and with ``profile: true``
too (chip_smoke.py phase 25's full run). For each it prints epochs 2 on: img/s with the
loader feeding the step, the median of the epochs' step medians, the wait
on the loader per step, the bytes handed to the step per batch, the decode
cache's hit rate, the peak of ``torch.cuda.max_memory_allocated``, the last
epoch's loss and the AP, beside the card's name and power limit.
"""
import argparse
import itertools
import json
import os
import tempfile

import torch

import chip_smoke as cs

VARIANTS = (
    ("true", ("device_pipeline=True",)),
    ("full", ("device_pipeline=full",)),
    ("full + cache + frames", ("device_pipeline=full", f"decode_cache_mb={cs.FULL_CACHE_MB}",
                               "frame_grouped_shuffle=True")),
    ("full + patches", ("device_pipeline=full", "patch_grouped_batching=True")),
    ("full + all", ("device_pipeline=full", f"decode_cache_mb={cs.FULL_CACHE_MB}",
                    "frame_grouped_shuffle=True", "patch_grouped_batching=True")),
    ("full + all + profile", ("device_pipeline=full", f"decode_cache_mb={cs.FULL_CACHE_MB}",
                              "frame_grouped_shuffle=True", "patch_grouped_batching=True",
                              "profile=True")),
)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=cs.INPUT_EPOCHS)
    p.add_argument("--warmup", type=int, default=cs.INPUT_WARMUP)
    p.add_argument("--repeat", type=int, default=1, help="runs of each variant")
    p.add_argument("--variants", default=None,
                   help="comma-separated names of the variants to run (default: all)")
    p.add_argument("--out", default=None, help="write the rows as JSON here")
    args = p.parse_args()
    names = [v.strip() for v in args.variants.split(",")] if args.variants else None
    variants = [(n, o) for n, o in VARIANTS if names is None or n in names]
    if names is not None and len(variants) != len(names):
        raise SystemExit(f"unknown variant in {names}; known: {[n for n, _ in VARIANTS]}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_input.py measures the GPU: no CUDA device")
    device = torch.device("cuda", 0)
    gpu = cs.gpu_name_and_power()
    print(f"gpu: {gpu}")
    cs.build_kernels()
    rows = []
    with tempfile.TemporaryDirectory() as root:
        data = cs.write_synthetic_coco(root, cs.ENTRY_TRAIN_IMAGES, cs.ENTRY_VAL_IMAGES,
                                       cs.ENTRY_PEOPLE)
        for (name, options), repeat in itertools.product(variants, range(args.repeat)):
            run_args = cs.recipe_args(cs.RECIPE_YAML, data,
                                      os.path.join(root, f"{name.replace(' ', '')}{repeat}"),
                                      device, f"num_epochs={args.epochs}",
                                      f"warmup={args.warmup}", f"val_interval={args.epochs}",
                                      *options)
            run = cs.train_recipe(run_args, f"variant {name}")
            epochs = run["result"]["epochs"][1:]
            cache = run["result"]["decode_cache"]
            row = {
                "variant": name,
                "warmup": args.warmup,
                "repeat": repeat,
                "images_per_sec": run["images_per_sec"],
                "step_median_ms": run["step_median_ms"],
                "wait_per_step_ms": run["wait_per_step_ms"],
                "batch_bytes": sum(e["batch_bytes"] for e in epochs) / sum(e["steps"]
                                                                         for e in epochs),
                "cache_hit_rate": (cache["hits"] / (cache["hits"] + cache["misses"])
                                   if cache else None),
                "peak_bytes": run["peak_bytes"],
                "last_loss": run["losses"][-1],
                "AP": run["stats"].get("AP"),
            }
            rows.append(row)
            print(f"ROW {json.dumps(row)}")
            del run
            torch.cuda.empty_cache()
    cs.stop_worker_servers()
    print(f"{'variant':24s} {'img/s':>7s} {'step ms':>8s} {'wait ms':>8s} {'MB/batch':>9s} "
          f"{'hit rate':>8s} {'peak GB':>8s} {'AP':>7s}")
    for r in rows:
        hit = f"{r['cache_hit_rate']:.3f}" if r["cache_hit_rate"] is not None else "-"
        print(f"{r['variant']:24s} {r['images_per_sec']:7.1f} {r['step_median_ms']:8.1f} "
              f"{r['wait_per_step_ms']:8.1f} {r['batch_bytes'] / 1e6:9.2f} {hit:>8s} "
              f"{r['peak_bytes'] / 1e9:8.2f} {r['AP']:7.4f}")
    print(gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": gpu, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
