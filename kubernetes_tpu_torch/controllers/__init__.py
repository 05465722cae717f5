"""Controller manager layer (cmd/kube-controller-manager + pkg/controller).

A copy of the reference package's module
(kubernetes_tpu/controllers/__init__.py).
"""

from .base import Controller, ControllerManager
from .cronjob import CronJobController
from .disruption import DisruptionController
from .hpa import HPAController
from .quota import QuotaController, quota_admission
from .serviceaccount import ServiceAccountController
from .volume import PersistentVolumeController
from .lifecycle import (
    EndpointSliceController,
    GarbageCollector,
    PodGCController,
    NamespaceController,
    NodeLifecycleController,
    ResourceClaimController,
    TTLAfterFinishedController,
)
from .workloads import (
    DaemonSetController,
    DeploymentController,
    JobController,
    ReplicaSetController,
    StatefulSetController,
)


def default_controllers(store, clock=None, ca_cert: str = "",
                        ca_key: str = "") -> list[Controller]:
    """The controller set kube-controller-manager starts by default, all on
    ONE shared informer factory (SharedInformerFactory semantics — each kind
    gets a single watch + cache, fanned out to every controller). The CSR
    signing controller joins only when the cluster CA is provided (the
    reference gates it on --cluster-signing-cert-file the same way)."""
    from ..client.informer import InformerFactory
    from .attachdetach import AttachDetachController
    from .certificates import CSRApprovingController, CSRSigningController
    from .devicetainteviction import DeviceTaintEvictionController

    informers = InformerFactory(store)
    out = [
        AttachDetachController(store, informers),
        CSRApprovingController(store, informers),
        DeviceTaintEvictionController(store, informers),
    ]
    if ca_cert:
        out.append(CSRSigningController(store, informers,
                                        ca_cert=ca_cert, ca_key=ca_key))
    return out + [
        DeploymentController(store, informers),
        ReplicaSetController(store, informers),
        JobController(store, informers, clock=clock),
        GarbageCollector(store, informers),
        NodeLifecycleController(store, informers, clock=clock),
        ResourceClaimController(store, informers),
        EndpointSliceController(store, informers),
        DisruptionController(store, informers),
        StatefulSetController(store, informers),
        DaemonSetController(store, informers),
        NamespaceController(store, informers),
        TTLAfterFinishedController(store, informers, clock=clock),
        CronJobController(store, informers, clock=clock),
        HPAController(store, informers, clock=clock),
        QuotaController(store, informers),
        PodGCController(store, informers),
        PersistentVolumeController(store, informers),
        ServiceAccountController(store, informers),
    ]


__all__ = [
    "Controller", "ControllerManager", "CronJobController",
    "DaemonSetController",
    "DeploymentController", "DisruptionController",
    "EndpointSliceController", "GarbageCollector", "PodGCController", "HPAController",
    "JobController",
    "NamespaceController", "NodeLifecycleController",
    "QuotaController", "ReplicaSetController", "ResourceClaimController",
    "PersistentVolumeController", "ServiceAccountController",
    "StatefulSetController", "TTLAfterFinishedController",
    "default_controllers", "quota_admission",
]
