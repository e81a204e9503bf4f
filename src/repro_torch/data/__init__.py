from .pipeline import DataConfig, device_batch, host_batch  # noqa: F401
