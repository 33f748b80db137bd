"""Shared utilities: runtime statistics."""

from nnstreamer_tpu_torch.utils.stats import InvokeStats  # noqa: F401
