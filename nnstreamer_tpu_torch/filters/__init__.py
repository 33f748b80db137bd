"""L4/L5 — filter-framework API and backend subplugins."""

from nnstreamer_tpu_torch.filters.api import (  # noqa: F401
    FilterFramework,
    FilterProperties,
    shared_model_get,
    shared_model_insert,
    shared_model_remove,
)
from nnstreamer_tpu_torch.filters.custom import register_custom_easy  # noqa: F401
