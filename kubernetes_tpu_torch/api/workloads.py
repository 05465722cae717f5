"""Workload + networking API types: ReplicaSet, Deployment, Job, Service,
EndpointSlice, Namespace.

Reference: staging/src/k8s.io/api/apps/v1/types.go (Deployment, ReplicaSet),
batch/v1/types.go (Job), core/v1 (Service, Namespace),
discovery/v1/types.go (EndpointSlice). Scheduling/controller-relevant subset.

A copy of the reference package's module (kubernetes_tpu/api/workloads.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .labels import LabelSelector
from .meta import ObjectMeta
from .types import PodSpec


@dataclass
class PodTemplateSpec:
    labels: dict[str, str] = field(default_factory=dict)
    spec: PodSpec = field(default_factory=PodSpec)


# --- apps/v1 ----------------------------------------------------------------


@dataclass
class ReplicaSetSpec:
    replicas: int = 1
    selector: LabelSelector | None = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class ReplicaSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicaSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicaSetSpec = field(default_factory=ReplicaSetSpec)
    status: ReplicaSetStatus = field(default_factory=ReplicaSetStatus)

    kind = "ReplicaSet"


@dataclass
class DeploymentStrategy:
    type: str = "RollingUpdate"  # RollingUpdate | Recreate
    max_surge: int = 1
    max_unavailable: int = 0


@dataclass
class DeploymentSpec:
    replicas: int = 1
    selector: LabelSelector | None = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: DeploymentStrategy = field(default_factory=DeploymentStrategy)
    # rollout pause (kubectl rollout pause): template changes don't roll
    # while paused; pure scaling of the current RS still applies
    paused: bool = False


@dataclass
class DeploymentStatus:
    replicas: int = 0
    updated_replicas: int = 0
    ready_replicas: int = 0
    observed_generation: int = 0


@dataclass
class Deployment:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)

    kind = "Deployment"


@dataclass
class StatefulSetSpec:
    """apps/v1 StatefulSetSpec (scheduling/controller-relevant subset)."""

    replicas: int = 1
    selector: LabelSelector | None = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    service_name: str = ""
    # OrderedReady: ordinal i+1 waits for ordinal i to be running;
    # Parallel: all at once (apps/v1 PodManagementPolicyType)
    pod_management_policy: str = "OrderedReady"
    # volumeClaimTemplates: per-ordinal stable storage — the controller
    # mints PVC <tpl>-<set>-<ordinal> and mounts it; the PVC OUTLIVES its
    # pod, so a recreated ordinal reattaches the same data
    volume_claim_templates: tuple = ()  # tuple[storage.PersistentVolumeClaim]


@dataclass
class StatefulSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    observed_generation: int = 0


@dataclass
class StatefulSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)

    kind = "StatefulSet"


@dataclass
class DaemonSetSpec:
    selector: LabelSelector | None = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    # RollingUpdate strategy: at most this many nodes may be without a
    # running daemon during a template roll (apps/v1 default 1)
    max_unavailable: int = 1


@dataclass
class DaemonSetStatus:
    desired_number_scheduled: int = 0
    current_number_scheduled: int = 0
    number_ready: int = 0


@dataclass
class DaemonSet:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)

    kind = "DaemonSet"


# --- batch/v1 ---------------------------------------------------------------


@dataclass
class JobSpec:
    completions: int = 1
    parallelism: int = 1
    backoff_limit: int = 6
    selector: LabelSelector | None = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    # batch/v1 ttlSecondsAfterFinished: the TTL-after-finished controller
    # deletes the Job this long after it completes (None = keep forever)
    ttl_seconds_after_finished: int | None = None
    # batch/v1 activeDeadlineSeconds: the job controller fails the whole
    # job (terminating its pods) once it has run this long
    active_deadline_seconds: int | None = None


@dataclass
class JobStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    completed: bool = False
    completion_time: float | None = None
    start_time: float | None = None
    # terminal failure reason ("BackoffLimitExceeded"/"DeadlineExceeded" —
    # the Failed condition's reason in batch/v1)
    failure_reason: str = ""


@dataclass
class Job:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)

    kind = "Job"


@dataclass
class PodMetrics:
    """metrics.k8s.io/v1beta1 PodMetrics subset: per-pod usage published by
    the node agent (the metrics-server role) and consumed by the HPA."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    cpu_usage_milli: int = 0
    memory_usage_bytes: int = 0
    window_s: float = 15.0

    kind = "PodMetrics"


@dataclass
class HPASpec:
    """autoscaling/v2 subset: one CPU-utilization metric target."""

    scale_target_kind: str = "Deployment"
    scale_target_name: str = ""
    min_replicas: int = 1
    max_replicas: int = 10
    target_cpu_utilization_percent: int = 80
    # scale-down stabilization (autoscaling/v2 behavior.scaleDown default
    # 300s): the controller applies the HIGHEST recommendation in the window
    scale_down_stabilization_s: float = 300.0


@dataclass
class HPAStatus:
    current_replicas: int = 0
    desired_replicas: int = 0
    current_cpu_utilization_percent: int | None = None
    last_scale_time: float | None = None


@dataclass
class HorizontalPodAutoscaler:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: HPASpec = field(default_factory=HPASpec)
    status: HPAStatus = field(default_factory=HPAStatus)

    kind = "HorizontalPodAutoscaler"


@dataclass
class CronJobSpec:
    """batch/v1 CronJobSpec subset: 5-field cron schedule + concurrency
    policy + history limits."""

    schedule: str = "* * * * *"
    job_template: JobSpec = field(default_factory=JobSpec)
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    suspend: bool = False
    successful_jobs_history_limit: int = 3
    failed_jobs_history_limit: int = 1
    starting_deadline_seconds: int | None = None


@dataclass
class CronJobStatus:
    last_schedule_time: float | None = None
    active: tuple[str, ...] = ()  # job keys


@dataclass
class CronJob:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CronJobSpec = field(default_factory=CronJobSpec)
    status: CronJobStatus = field(default_factory=CronJobStatus)

    kind = "CronJob"


# --- core/v1 Service + discovery/v1 EndpointSlice ---------------------------


@dataclass(frozen=True)
class ServicePort:
    port: int
    target_port: int = 0
    protocol: str = "TCP"
    name: str = ""
    node_port: int = 0


@dataclass
class ServiceSpec:
    selector: dict[str, str] = field(default_factory=dict)
    ports: tuple[ServicePort, ...] = ()
    cluster_ip: str = ""
    type: str = "ClusterIP"
    # core/v1 ServiceSpec traffic-routing knobs consumed by the proxy layer
    session_affinity: str = "None"  # "None" | "ClientIP"
    session_affinity_timeout_s: int = 10800
    internal_traffic_policy: str = "Cluster"  # "Cluster" | "Local"
    external_traffic_policy: str = "Cluster"  # "Cluster" | "Local"


@dataclass
class Service:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)

    kind = "Service"


@dataclass(frozen=True)
class Endpoint:
    addresses: tuple[str, ...]
    node_name: str = ""
    ready: bool = True
    target_pod: str = ""  # pod key
    # discovery/v1 EndpointConditions: serving mirrors readiness but stays
    # true for terminating pods; the proxy falls back to serving-terminating
    # endpoints when a service has no ready ones (pkg/proxy/topology.go)
    serving: bool = True
    terminating: bool = False


@dataclass
class EndpointSlice:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    service_name: str = ""
    endpoints: tuple[Endpoint, ...] = ()
    ports: tuple[ServicePort, ...] = ()

    kind = "EndpointSlice"


@dataclass
class Namespace:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    phase: str = "Active"

    kind = "Namespace"


@dataclass
class ConfigMap:
    """core/v1 ConfigMap: plain key→value configuration data."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    data: dict[str, str] = field(default_factory=dict)

    kind = "ConfigMap"


@dataclass
class Secret:
    """core/v1 Secret subset: stringData semantics (values handled as
    strings; at-rest encoding is the store's concern, not the type's)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    data: dict[str, str] = field(default_factory=dict)
    type: str = "Opaque"

    kind = "Secret"


@dataclass
class ResourceQuota:
    """core/v1 ResourceQuota subset: hard caps per namespace over
    requests.cpu / requests.memory (milli / MiB) and object counts
    ("pods", "count/<kind>"). `used` is maintained by the quota controller
    and enforced at admission."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    hard: dict[str, int] = field(default_factory=dict)
    used: dict[str, int] = field(default_factory=dict)

    kind = "ResourceQuota"
