"""Declarative serve config — the ``serve deploy config.yaml`` surface.

Own copy of ``ray_dynamic_batching_tpu/serve/schema.py``, whole, with its
import paths rewritten; the ``llm:`` target builds the port's
:class:`~ray_dynamic_batching_tpu_torch.serve.llm.LLMDeployment`, and the
CLI is ``python -m ray_dynamic_batching_tpu_torch.serve.schema``.

Re-creates the reference's config-driven deployment path (pydantic schemas
in ``python/ray/serve/schema.py``, applied by ``serve deploy`` /
``serve.run`` with ``import_path`` app targets): a JSON/YAML document
describing applications and their deployments, validated into dataclasses,
resolved via ``module:attribute`` import paths, and applied to a
controller. TPU addition: a deployment may instead declare a built-in
``llm`` target (model name + decode-engine knobs) — the flagship serving
path needs no user module.

```yaml
applications:
  - name: text
    route_prefix: /classify
    deployments:
      - name: classifier
        import_path: my_pkg.apps:classifier_app   # Deployment or Application
        num_replicas: 2
  - name: chat
    deployments:
      - name: llama
        llm: {model: llama_tiny, num_slots: 8}
        # Multi-tenant QoS (DeploymentConfig fields flow straight through):
        default_qos_class: interactive     # tier for undeclared requests
        admission_rate_rps: 500.0          # per-(tenant, class) bucket
```
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_dynamic_batching_tpu_torch.serve.api import (
    Application,
    Deployment,
    run as _run_app,
)
from ray_dynamic_batching_tpu_torch.serve.autoscaling import AutoscalingConfig
from ray_dynamic_batching_tpu_torch.serve.controller import DeploymentConfig
from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.schema")

# DeploymentConfig fields a config document may set directly.
_CONFIG_FIELDS = frozenset(DeploymentConfig.__dataclass_fields__) - {
    "name", "autoscaling", "user_config"
}


@dataclass
class DeploymentSchema:
    """One deployment entry (ref schema.py DeploymentSchema)."""

    name: str
    import_path: Optional[str] = None
    llm: Optional[Dict[str, Any]] = None
    init_args: List[Any] = field(default_factory=list)
    init_kwargs: Dict[str, Any] = field(default_factory=dict)
    autoscaling: Optional[Dict[str, Any]] = None
    user_config: Dict[str, Any] = field(default_factory=dict)
    options: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DeploymentSchema":
        if "name" not in d:
            raise ValueError("deployment entry missing 'name'")
        known = {"name", "import_path", "llm", "init_args", "init_kwargs",
                 "autoscaling", "user_config"}
        options = {k: v for k, v in d.items() if k not in known}
        bad = set(options) - _CONFIG_FIELDS
        if bad:
            raise ValueError(
                f"deployment {d['name']!r}: unknown fields {sorted(bad)}"
            )
        return DeploymentSchema(
            name=d["name"],
            import_path=d.get("import_path"),
            llm=d.get("llm"),
            init_args=list(d.get("init_args", ())),
            init_kwargs=dict(d.get("init_kwargs", {})),
            autoscaling=d.get("autoscaling"),
            user_config=dict(d.get("user_config", {})),
            options=options,
        )


@dataclass
class ApplicationSchema:
    """One application: a route prefix plus its deployments (ref
    ServeApplicationSchema)."""

    name: str
    deployments: List[DeploymentSchema]
    route_prefix: Optional[str] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ApplicationSchema":
        if "name" not in d:
            raise ValueError("application entry missing 'name'")
        deps = d.get("deployments") or []
        if not deps:
            raise ValueError(f"application {d['name']!r} has no deployments")
        return ApplicationSchema(
            name=d["name"],
            deployments=[DeploymentSchema.from_dict(x) for x in deps],
            route_prefix=d.get("route_prefix"),
        )


@dataclass
class ServeConfigSchema:
    """Top-level document (ref ServeDeploySchema)."""

    applications: List[ApplicationSchema]

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ServeConfigSchema":
        apps = d.get("applications") or []
        if not apps:
            raise ValueError("config has no applications")
        names = [a.get("name") for a in apps]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate application names in {names}")
        schema = ServeConfigSchema(
            applications=[ApplicationSchema.from_dict(a) for a in apps]
        )
        # Deployment names are controller-global: a duplicate ACROSS apps
        # would alias both onto one deployment (old factory, new config)
        # with no error from the controller.
        dep_names = [
            d.name for a in schema.applications for d in a.deployments
        ]
        dupes = {n for n in dep_names if dep_names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate deployment names: {sorted(dupes)}")
        return schema


def load_config(path: str) -> ServeConfigSchema:
    """Parse a JSON or YAML config file into the validated schema."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml  # lazy: only YAML documents need it

        doc = yaml.safe_load(text)
    else:
        doc = json.loads(text)
    return ServeConfigSchema.from_dict(doc)


def _import_target(import_path: str) -> Any:
    """Resolve ``module.path:attribute`` (ref common.py import_attr)."""
    if ":" not in import_path:
        raise ValueError(
            f"import_path {import_path!r} must be 'module:attribute'"
        )
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def _build_application(spec: DeploymentSchema) -> Any:
    """Deployment entry -> something deployable: an Application from an
    import path, or a built-in LLMDeployment."""
    if (spec.import_path is None) == (spec.llm is None):
        raise ValueError(
            f"deployment {spec.name!r}: exactly one of import_path/llm"
        )
    if spec.llm is not None:
        if spec.init_args or spec.init_kwargs:
            raise ValueError(
                f"deployment {spec.name!r}: llm targets take their knobs "
                "inside the llm mapping; drop init_args/init_kwargs"
            )
        from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

        llm_kwargs = dict(spec.llm)
        model = llm_kwargs.pop("model", None)
        if model is None:
            raise ValueError(f"deployment {spec.name!r}: llm needs 'model'")
        return LLMDeployment(model, **llm_kwargs)
    target = _import_target(spec.import_path)
    if isinstance(target, Application):
        if spec.init_args or spec.init_kwargs:
            raise ValueError(
                f"deployment {spec.name!r}: import_path already bound; "
                "drop init_args/init_kwargs"
            )
        return target
    if isinstance(target, Deployment):
        return target.bind(*spec.init_args, **spec.init_kwargs)
    if callable(target):  # bare class/function: wrap with defaults
        from ray_dynamic_batching_tpu_torch.serve.api import deployment

        return deployment(target).bind(*spec.init_args, **spec.init_kwargs)
    raise TypeError(
        f"deployment {spec.name!r}: {spec.import_path} resolved to "
        f"{type(target).__name__}, not a Deployment/Application/callable"
    )


def apply_config(
    config: ServeConfigSchema,
    controller: Any = None,
) -> Dict[str, DeploymentHandle]:
    """Deploy every application; returns deployment-name -> handle (ref
    serve deploy applying ServeDeploySchema via the controller)."""
    handles: Dict[str, DeploymentHandle] = {}
    for app in config.applications:
        for i, spec in enumerate(app.deployments):
            built = _build_application(spec)
            overrides = dict(spec.options)
            overrides["name"] = spec.name
            if spec.user_config:
                overrides["user_config"] = spec.user_config
            if spec.autoscaling is not None:
                overrides["autoscaling"] = AutoscalingConfig(
                    **spec.autoscaling
                )
            # Route goes to the app's FIRST deployment (the app ingress,
            # ref: one route_prefix per application).
            route = app.route_prefix if i == 0 else None
            if isinstance(built, Application):
                built = Application(
                    built.deployment.options(**overrides),
                    built.args, built.kwargs,
                )
                handles[spec.name] = _run_app(
                    built, route_prefix=route, controller=controller
                )
            else:
                # Built-in deployment object (LLMDeployment): controller
                # factory path with config assembled from the schema.
                from ray_dynamic_batching_tpu_torch.serve.api import (
                    _get_controller,
                    _get_proxy,
                )

                cfg_kwargs = {
                    k: v for k, v in overrides.items() if k != "name"
                }
                cfg = DeploymentConfig(name=spec.name, **cfg_kwargs)
                ctl = controller or _get_controller()
                router = ctl.deploy(cfg, factory=built)
                handles[spec.name] = DeploymentHandle(
                    router, default_qos_class=cfg.default_qos_class
                )
                if route is not None:
                    proxy = _get_proxy()
                    # Same wiring as serve.api.run: the front door must
                    # grade against THIS controller's admission table or
                    # a YAML-configured admission_rate_rps is a no-op.
                    proxy.admission = ctl.admission
                    proxy.router.set_route(route, handles[spec.name])
        logger.info(
            "application %s: deployed %s",
            app.name, [d.name for d in app.deployments],
        )
    return handles


def run_config(path: str, controller: Any = None) -> Dict[str, DeploymentHandle]:
    """``serve deploy <file>`` in one call: load, validate, apply."""
    return apply_config(load_config(path), controller=controller)


def _main() -> int:
    """``python -m ray_dynamic_batching_tpu_torch.serve.schema <config> [--block]``
    — the ``serve deploy`` CLI role."""
    import sys
    import time

    args = [a for a in sys.argv[1:] if a != "--block"]
    if not args:
        print("usage: python -m ray_dynamic_batching_tpu_torch.serve.schema "
              "<config.{json,yaml}> [--block]", file=sys.stderr)
        return 2
    handles = run_config(args[0])
    from ray_dynamic_batching_tpu_torch.serve.api import get_proxy

    proxy = get_proxy()
    print(json.dumps({
        "deployments": sorted(handles),
        "http": f"http://127.0.0.1:{proxy.port}" if proxy else None,
    }))
    if "--block" in sys.argv:
        try:
            while True:  # rdb-lint: disable=unbounded-retry (CLI --block foreground park, not a retry loop; the only exit is KeyboardInterrupt by design)
                time.sleep(3600)  # rdb-lint: disable=event-loop-blocking (CLI --block foreground park; blocking is the point of the flag)
        except KeyboardInterrupt:
            pass
        from ray_dynamic_batching_tpu_torch.serve.api import shutdown

        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
