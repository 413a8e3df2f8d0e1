from .topdown_transform import box_to_center_scale, crop_matrix  # noqa: F401
