"""Import-all registry front door: importing it registers every model."""

from ray_dynamic_batching_tpu_torch.models import causal_lm  # noqa: F401
from ray_dynamic_batching_tpu_torch.models.base import (  # noqa: F401
    ModelSLO,
    ServableModel,
    get_model,
    registered_models,
)
