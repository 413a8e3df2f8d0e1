"""Column names of the batches the loader yields.

Copy of the top-down, bottom-up and image-folder entries of
``mindpose_tpu/data/column_names.py`` (:18, :21-38): the names are the
contract between the loader and its consumers. Train: the train step's
positional inputs, in order (image, heatmap target, target weight; for
bottom-up, with the mask and the tag indices). Val: what the inferencer
reads.
"""

FINAL_COLUMN_MAP = {
    "topdown": {
        "train": "image target target_weight".split(),
        "val": "image image_file boxes bbox_ids center scale bbox_scores".split(),
    },
    "bottomup": {
        "train": "image target mask tag_ind".split(),
        "val": "image mask center scale image_file image_shape".split(),
    },
    "imagefolder_bottomup": {
        "val": "image mask center scale image_file image_shape".split(),
    },
}
