"""Import-all registry front door: importing it registers every model."""

from ray_dynamic_batching_tpu_torch.models import (  # noqa: F401
    asr,
    causal_lm,
    distilbert,
    efficientnet,
    resnet,
    shufflenet,
    vit,
)
from ray_dynamic_batching_tpu_torch.models.base import (  # noqa: F401
    ModelSLO,
    ServableModel,
    get_model,
    get_slo,
    registered_models,
)
