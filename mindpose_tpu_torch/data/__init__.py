from .data_factory import create_dataset, create_pipeline  # noqa: F401
