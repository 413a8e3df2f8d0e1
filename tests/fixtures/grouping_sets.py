"""Seeded candidate sets of the tag matcher, shaped like the bottom-up decoder's output.

numpy only: ``chip_smoke.py`` (which imports no JAX) and the CPU tests
share it.
"""
import numpy as np

# configs/higher_hrnet/higher_hrnet_w32_tpu.yaml's joint_order
ORDER = [0, 1, 2, 3, 4, 5, 6, 11, 12, 7, 8, 9, 10, 13, 14, 15, 16]

# (name, candidate_sets kwargs, group_cap): the last two spawn more groups
# than the capacity holds
SETS = [
    ("5 persons", dict(persons=5, spread=3.0, visible=0.3), 0),
    ("close tags", dict(persons=5, spread=0.5, visible=0.6), 0),
    ("40 persons, all visible", dict(persons=40, spread=10.0, visible=1.0), 0),
    ("capacity 4", dict(persons=8, spread=3.0, visible=1.0), 4),
]

# Sets whose costs tie exactly, kept apart so that the draws of SETS stay as
# they were: tags on a grid of halves with no noise, so that a person's
# candidates share one tag (duplicate cost rows) and persons share tags
# (duplicate groups); the rounded costs, eps * d and the reduced costs then
# tie, and the matcher's first-index tie-break decides the assignment
TIE_SETS = [
    ("grid tags", dict(persons=5, spread=3.0, visible=0.6, grid=0.5), 0),
    ("grid tags, 8 persons on 5 tags", dict(persons=8, spread=1.0, visible=1.0, grid=0.5), 0),
]


def candidate_sets(rng, n, k=17, m=30, tag_dim=1, persons=5, spread=3.0, visible=0.3, grid=0.0):
    """``n`` images' candidates (val_k [n, k, m], tag_k [n, k, m, tag_dim],
    ind_k [n, k, m, 2], float32) shaped like the decoder's: per joint the
    top-M values sorted (about ``visible`` of them above 0.1), each
    candidate a person's tag plus noise, integer heatmap positions. With
    ``grid``, the persons' tags are multiples of ``grid`` within ``spread``
    and the candidates carry them with no noise."""
    val = np.sort(rng.uniform(0, 1, (n, k, m)), axis=2)[..., ::-1]
    val = val * (rng.uniform(0, 1, (n, k, 1)) < 0.9)  # some joints see nobody
    val = np.where(rng.uniform(0, 1, (n, k, m)) < visible, val, 0.1 * val)
    if grid:
        steps = int(spread / grid)
        person_tags = grid * rng.randint(-steps, steps + 1, (n, persons, tag_dim))
        who = rng.randint(0, persons, (n, k, m))
        tag = person_tags[np.arange(n)[:, None, None], who]
    else:
        person_tags = rng.uniform(-spread, spread, (n, persons, tag_dim))
        who = rng.randint(0, persons, (n, k, m))
        tag = (person_tags[np.arange(n)[:, None, None], who]
               + rng.normal(0, 0.2, (n, k, m, tag_dim)))
    ind = rng.randint(0, 128, (n, k, m, 2))
    return val.astype(np.float32), tag.astype(np.float32), ind.astype(np.float32)
