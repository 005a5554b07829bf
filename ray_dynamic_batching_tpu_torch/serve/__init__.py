"""Serving substrate: controller, routers, replicas, handles, long poll.

Re-creation of Ray Serve's architecture, in the port as in
``ray_dynamic_batching_tpu/serve/__init__.py``: a controller reconciles
deployment state and checkpoints it; routers schedule requests over
replicas with power-of-two-choices; replicas run user callables with
size-or-timeout batching; config changes flow over long poll. Re-exports
the reference's list.
"""

from ray_dynamic_batching_tpu_torch.serve.api import (
    Application,
    Deployment,
    batch,
    delete,
    deployment,
    get_deployment_handle,
    multiplexed,
    run,
    shutdown,
    status,
)
from ray_dynamic_batching_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
    AdmissionRejected,
    TokenBucket,
)
from ray_dynamic_batching_tpu_torch.serve.autoscaling import (
    AutoscalingConfig,
    AutoscalingPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.controller import (
    DeploymentConfig,
    ServeController,
)
from ray_dynamic_batching_tpu_torch.serve.fabric import (
    ControlFabric,
    FabricUnreachable,
    default_fabric,
    parse_partition_spec,
    reset_fabric,
)
from ray_dynamic_batching_tpu_torch.serve.frontdoor import (
    FrontDoor,
    FrontDoorShard,
    GlobalBudget,
    HashRing,
)
from ray_dynamic_batching_tpu_torch.serve.store import (
    CompactedLogError,
    ControllerStore,
    InMemoryStore,
    LeaderLease,
    ReplicaCatalog,
    ReplicatedStore,
    StaleEpochError,
    StoreLog,
    StoreSnapshot,
)
from ray_dynamic_batching_tpu_torch.serve.failover import (
    DrainEvicted,
    FailoverManager,
    FailoverPolicy,
    HedgeManager,
    HedgePolicy,
    ReplicaDeadError,
    SliceDeadError,
    RetriesExhausted,
    RetryableSystemError,
    is_retryable,
    is_shed,
    reject_disposition,
)
from ray_dynamic_batching_tpu_torch.serve.grayhealth import (
    GrayHealthMonitor,
    GrayHealthPolicy,
)
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment, LLMReplica
from ray_dynamic_batching_tpu_torch.serve.long_poll import LongPollClient, LongPollHost
from ray_dynamic_batching_tpu_torch.serve.openai_api import CompletionsHandle
from ray_dynamic_batching_tpu_torch.serve.proxy import HTTPProxy, ProxyRouter
from ray_dynamic_batching_tpu_torch.serve.replica import Replica
from ray_dynamic_batching_tpu_torch.serve.router import Router
from ray_dynamic_batching_tpu_torch.serve.schema import (
    ServeConfigSchema,
    apply_config,
    load_config,
    run_config,
)

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "AdmissionRejected",
    "TokenBucket",
    "reject_disposition",
    "Application",
    "Deployment",
    "batch",
    "delete",
    "deployment",
    "get_deployment_handle",
    "multiplexed",
    "run",
    "shutdown",
    "status",
    "AutoscalingConfig",
    "AutoscalingPolicy",
    "CompactedLogError",
    "CompletionsHandle",
    "ControlFabric",
    "ControllerStore",
    "default_fabric",
    "DeploymentConfig",
    "DeploymentHandle",
    "DrainEvicted",
    "FabricUnreachable",
    "FrontDoor",
    "FrontDoorShard",
    "GlobalBudget",
    "HashRing",
    "InMemoryStore",
    "LeaderLease",
    "ReplicaCatalog",
    "ReplicatedStore",
    "StaleEpochError",
    "StoreLog",
    "StoreSnapshot",
    "parse_partition_spec",
    "reset_fabric",
    "FailoverManager",
    "FailoverPolicy",
    "GrayHealthMonitor",
    "GrayHealthPolicy",
    "HedgeManager",
    "HedgePolicy",
    "ReplicaDeadError",
    "SliceDeadError",
    "RetriesExhausted",
    "RetryableSystemError",
    "is_retryable",
    "is_shed",
    "HTTPProxy",
    "LLMDeployment",
    "LLMReplica",
    "LongPollClient",
    "LongPollHost",
    "ProxyRouter",
    "Replica",
    "Router",
    "ServeConfigSchema",
    "ServeController",
    "apply_config",
    "load_config",
    "run_config",
]
