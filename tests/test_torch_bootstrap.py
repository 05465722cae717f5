"""The port's kubeadm init, proxy and controller-manager binaries held to
the reference's own suites.

Each of tests/test_bootstrap.py, test_e2e_cluster.py, test_cmd_binaries.py
and test_proxy.py is read, turned to the port's names
(tests/torch_suites.py; every ClusterBootstrap, Scheduler and
SchedulerServer takes `device="cpu"`) and executed into this module, so
every case of those suites is collected here as a case of the port.
NOT_PORTED lists the cases that need the full kubelet (`KubeletServer`,
`PodStats`: ROADMAP A16); every other case runs on the port.
"""

from __future__ import annotations

import pytest

from tests.torch_suites import load_suites

SUITES = ("test_bootstrap", "test_e2e_cluster", "test_cmd_binaries",
          "test_proxy")

# suite -> case names (Class.method or function) left out
NOT_PORTED = {
    "test_cmd_binaries": {
        # the full kubelet's KubeletServer (A16)
        "test_rest_kubelet_and_kcm_run_a_deployment",
    },
    "test_e2e_cluster": {
        # the full kubelet's PodStats feed the HPA (A16)
        "TestThreadedCluster.test_hpa_scales_under_threaded_load",
    },
}


def _edit(suite: str, src: str) -> str:
    if suite == "test_cmd_binaries":
        # the module-level import of the KubeletServer (A16) only its
        # NOT_PORTED case reads
        line = "from kubernetes_tpu_torch.cmd.kubelet import KubeletServer\n"
        assert line in src
        src = src.replace(line, "")
    return src


load_suites(globals(), SUITES, NOT_PORTED, _edit)


# ------------------------------------------------------ the port's own rules


def test_bootstrap_without_a_card_raises(monkeypatch):
    """No fallback: without a card and without device="cpu" the cluster
    is refused before any component starts."""
    import torch

    from kubernetes_tpu_torch.cmd.bootstrap import ClusterBootstrap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterBootstrap(nodes=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterBootstrap(nodes=1, device="cuda")


def test_converge_keeps_each_rounds_seconds_by_tier():
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.types import RUNNING, Container, PodSpec
    from kubernetes_tpu_torch.api.workloads import (
        Deployment, DeploymentSpec, PodTemplateSpec)
    from kubernetes_tpu_torch.cmd.bootstrap import ClusterBootstrap
    from kubernetes_tpu_torch.utils.clock import FakeClock

    boot = ClusterBootstrap(nodes=2, clock=FakeClock(), device="cpu")
    boot.init()
    try:
        boot.client().create(Deployment(
            meta=ObjectMeta(name="web"),
            spec=DeploymentSpec(replicas=3, template=PodTemplateSpec(
                labels={"app": "web"},
                spec=PodSpec(containers=[Container(requests={"cpu": "100m"})]))),
        ))
        boot.converge(rounds=3)
        assert len(boot.round_seconds) == 3
        assert all(set(r) == {"controllers", "scheduler", "kubelets", "proxies"}
                   and all(v >= 0 for v in r.values()) for r in boot.round_seconds)
        assert [p.status.phase for p in boot.store.pods()] == [RUNNING] * 3
    finally:
        boot.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout=30.0):
    import time

    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.05)


def test_the_binaries_run_a_cluster_and_stop_cleanly():
    """`python -m kubernetes_tpu_torch.cmd.bootstrap` prints its kubeconfig,
    runs a Deployment to Running in its threaded run() and exits 0 on
    SIGINT; `python -m kubernetes_tpu_torch.cmd.controller_manager
    --leader-elect` against it answers /healthz and takes the Lease."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.types import RUNNING, Container, PodSpec
    from kubernetes_tpu_torch.api.workloads import (
        Deployment, DeploymentSpec, PodTemplateSpec)
    from kubernetes_tpu_torch.client.rest import RESTStore

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    boot = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.bootstrap", "--nodes", "2",
         "--port", "0", "--device", "cpu"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    kcm = None
    try:
        cfg = json.loads(boot.stdout.readline())
        client = RESTStore(cfg["server"])
        client.create(Deployment(
            meta=ObjectMeta(name="web"),
            spec=DeploymentSpec(replicas=2, template=PodTemplateSpec(
                labels={"app": "web"},
                spec=PodSpec(containers=[Container(requests={"cpu": "100m"})]))),
        ))
        _wait(lambda: sum(1 for p in client.pods()
                          if p.status.phase == RUNNING and p.spec.node_name) == 2)
        port = _free_port()
        kcm = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.controller_manager",
             "--server", cfg["server"], "--leader-elect", "--port", str(port)],
            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

        def healthy():
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                            timeout=2) as r:
                    return r.status == 200
            except OSError:
                return False

        _wait(healthy)
        _wait(lambda: getattr(client.try_get(
            "Lease", "kube-system/kube-controller-manager"), "spec", None) is not None
            and client.get("Lease", "kube-system/kube-controller-manager")
            .spec.holder_identity == "kcm-0")
        kcm.terminate()
        kcm.wait(timeout=30)
        boot.send_signal(signal.SIGINT)
        assert boot.wait(timeout=60) == 0
    finally:
        for p in (kcm, boot):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
