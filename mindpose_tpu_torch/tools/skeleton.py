"""Skeleton-edge resolution shared by the demo CLIs.

A copy of ``tools/common/skeleton.py``, pinned to it by
``tests/test_torch_host_copies.py``. Default is the 17-joint COCO layout;
other layouts (MPII 16, CrowdPose 14) supply ``dataset_setting.skeleton`` in
their recipe, else only joint dots are drawn.
"""

COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]


def resolve_skeleton(args):
    """Config -> list of drawable (a, b) joint-index edges."""
    edges = (args.dataset_setting or {}).get("skeleton")
    if edges is None and args.num_joints == 17:
        edges = COCO_SKELETON
    return [
        (int(a), int(b)) for a, b in (edges or [])
        if 0 <= min(int(a), int(b)) and max(int(a), int(b)) < args.num_joints
    ]
