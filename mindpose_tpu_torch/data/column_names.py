"""Column names of the batches the loader yields.

Copy of the top-down val entry of ``mindpose_tpu/data/column_names.py``
(:32): the names are the contract between the loader and the inferencer.
The train columns come with the training loader.
"""

FINAL_COLUMN_MAP = {
    "topdown": {
        "val": "image image_file boxes bbox_ids center scale bbox_scores".split(),
    },
}
