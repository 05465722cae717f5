"""KubeSchedulerConfiguration: the scheduler's versioned component config.

Reference: pkg/scheduler/apis/config/types.go (KubeSchedulerConfiguration:37,
Parallelism:49 default 16, PercentageOfNodesToScore:70, profiles:100) with
v1 defaulting (apis/config/v1/defaults.go) and validation
(apis/config/validation/validation.go).

A copy of the reference package's module (kubernetes_tpu/config/types.py)
with two departures:

- every profile of the port runs its device backend, so
  `ProfileConfig.backend` defaults to "tpu" and a document naming the
  reference's "host" backend fails validation with "unknown backend"
  (`validate_profile`, which the Scheduler runs over its Profiles too);
- `load_config_file` reads JSON, which is YAML's flow subset, and only
  imports PyYAML for a file that is not JSON (the card's machine has no
  PyYAML).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

API_VERSION = "kubescheduler.config.tpu.io/v1"
KIND = "KubeSchedulerConfiguration"

DEFAULT_PARALLELISM = 16
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 0  # 0 = adaptive 50 - nodes/125

# the port's profiles all run on its device backend; the reference's
# "host" backend is not a profile of the port
BACKENDS = ("tpu",)


@dataclass
class PluginSet:
    enabled: list[str] = field(default_factory=list)
    disabled: list[str] = field(default_factory=list)  # ["*"] disables all


@dataclass
class ProfileConfig:
    scheduler_name: str = "default-scheduler"
    percentage_of_nodes_to_score: int | None = None
    plugins: PluginSet = field(default_factory=PluginSet)
    plugin_args: dict = field(default_factory=dict)  # plugin name -> args
    backend: str = "tpu"  # the port's device backend, the only one
    # >0: schedule each run of up to waveSize pods in one device launch
    # (equal to per-pod; throughput mode)
    wave_size: int = 0

    @property
    def name(self) -> str:
        """The name `validate_profile` reports (a Profile's `name`)."""
        return self.scheduler_name


@dataclass
class LeaderElectionConfig:
    leader_elect: bool = False
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    resource_name: str = "kube-scheduler"
    resource_namespace: str = "kube-system"


@dataclass
class SchedulerConfiguration:
    parallelism: int = DEFAULT_PARALLELISM
    percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE
    profiles: list[ProfileConfig] = field(default_factory=lambda: [ProfileConfig()])
    extenders: list = field(default_factory=list)  # ExtenderConfig
    feature_gates: dict[str, bool] = field(default_factory=dict)
    leader_election: LeaderElectionConfig = field(
        default_factory=LeaderElectionConfig
    )
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    health_bind_port: int = 0  # 0 = disabled

    def validate(self) -> list[str]:
        """validation.go ValidateKubeSchedulerConfiguration, in the
        reference's order; the per-profile checks are `validate_profiles`'."""
        errs = []
        if self.parallelism <= 0:
            errs.append("parallelism must be greater than 0")
        if not (0 <= self.percentage_of_nodes_to_score <= 100):
            errs.append("percentageOfNodesToScore must be in [0, 100]")
        if not self.profiles:
            errs.append("at least one profile is required")
        errs.extend(validate_profiles(self.profiles))
        if self.pod_initial_backoff_seconds <= 0:
            errs.append("podInitialBackoffSeconds must be greater than 0")
        if self.pod_max_backoff_seconds < self.pod_initial_backoff_seconds:
            errs.append("podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
        le = self.leader_election
        if le.leader_elect and le.renew_deadline >= le.lease_duration:
            errs.append("leaderElection.renewDeadline must be < leaseDuration")
        return errs


def validate_profile(profile) -> list[str]:
    """Errors of one profile (a scheduler Profile or a ProfileConfig: name,
    backend, wave_size, percentage_of_nodes_to_score); empty when valid."""
    errs = []
    name = profile.name
    if profile.backend not in BACKENDS:
        errs.append(f"profile {name}: unknown backend {profile.backend}")
    if profile.wave_size < 0:
        errs.append(f"profile {name}: waveSize must be >= 0")
    pct = profile.percentage_of_nodes_to_score
    if pct is not None and not 0 <= pct <= 100:
        errs.append(f"profile {name}: percentageOfNodesToScore out of range")
    return errs


def validate_profiles(profiles) -> list[str]:
    """Errors of a profile list: duplicate names, then each profile's."""
    errs = []
    names = [p.name for p in profiles]
    if len(names) != len(set(names)):
        errs.append("profile schedulerNames must be unique")
    for p in profiles:
        errs.extend(validate_profile(p))
    return errs


def load_config(data: dict) -> SchedulerConfiguration:
    """Decode + default a versioned config document (apis/config/v1 scheme)."""
    if data.get("apiVersion") not in (None, API_VERSION):
        raise ValueError(f"unsupported apiVersion {data.get('apiVersion')!r}")
    if data.get("kind") not in (None, KIND):
        raise ValueError(f"unsupported kind {data.get('kind')!r}")
    cfg = SchedulerConfiguration()
    cfg.parallelism = int(data.get("parallelism", DEFAULT_PARALLELISM))
    cfg.percentage_of_nodes_to_score = int(
        data.get("percentageOfNodesToScore", DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE)
    )
    cfg.feature_gates = dict(data.get("featureGates", {}))
    cfg.pod_initial_backoff_seconds = float(data.get("podInitialBackoffSeconds", 1.0))
    cfg.pod_max_backoff_seconds = float(data.get("podMaxBackoffSeconds", 10.0))
    cfg.health_bind_port = int(data.get("healthBindPort", 0))
    if "profiles" in data:
        cfg.profiles = []
        for p in data["profiles"]:
            plugins = p.get("plugins", {})
            args = {
                entry["name"]: entry.get("args", {})
                for entry in p.get("pluginConfig", [])
            }
            cfg.profiles.append(ProfileConfig(
                scheduler_name=p.get("schedulerName", "default-scheduler"),
                percentage_of_nodes_to_score=p.get("percentageOfNodesToScore"),
                plugins=PluginSet(
                    enabled=list(plugins.get("enabled", [])),
                    disabled=list(plugins.get("disabled", [])),
                ),
                plugin_args=args,
                backend=p.get("backend", "tpu"),
                wave_size=int(p.get("waveSize", 0)),
            ))
    if "extenders" in data:
        from ..scheduler.extender import ExtenderConfig

        cfg.extenders = [
            ExtenderConfig(
                url_prefix=e["urlPrefix"],
                filter_verb=e.get("filterVerb", ""),
                prioritize_verb=e.get("prioritizeVerb", ""),
                bind_verb=e.get("bindVerb", ""),
                weight=e.get("weight", 1),
                ignorable=e.get("ignorable", False),
                node_cache_capable=e.get("nodeCacheCapable", False),
                managed_resources=tuple(
                    r["name"] for r in e.get("managedResources", [])
                ),
            )
            for e in data["extenders"]
        ]
    if "leaderElection" in data:
        le = data["leaderElection"]
        cfg.leader_election = LeaderElectionConfig(
            leader_elect=le.get("leaderElect", False),
            lease_duration=float(le.get("leaseDurationSeconds", 15)),
            renew_deadline=float(le.get("renewDeadlineSeconds", 10)),
            retry_period=float(le.get("retryPeriodSeconds", 2)),
            resource_name=le.get("resourceName", "kube-scheduler"),
            resource_namespace=le.get("resourceNamespace", "kube-system"),
        )
    errs = cfg.validate()
    if errs:
        raise ValueError("invalid configuration: " + "; ".join(errs))
    return cfg


def load_config_file(path: str) -> SchedulerConfiguration:
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text) if text.strip() else {}
    except json.JSONDecodeError:
        import yaml  # a YAML document that is not JSON

        data = yaml.safe_load(text)
    return load_config(data or {})
