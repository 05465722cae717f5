"""The port's controller manager held to the reference's own suites.

Each of tests/test_controllers.py, test_cronjob.py, test_hpa.py,
test_statefulset_daemonset.py, test_serviceaccount.py,
test_pv_controller.py, test_attach_csr.py and test_device_taints.py is
read, turned to the port's names (tests/torch_suites.py) and executed
into this module, so every case of those suites is collected here as a
case of the port. NOT_PORTED lists the cases that need the full kubelet
(`Kubelet`, `PodStats`, `VolumeManager`: ROADMAP A16); every other case
runs on the port.
"""

from __future__ import annotations

from tests.torch_suites import load_suites

SUITES = ("test_controllers", "test_cronjob", "test_hpa",
          "test_statefulset_daemonset", "test_serviceaccount",
          "test_pv_controller", "test_attach_csr", "test_device_taints")

# suite -> case names (Class.method or function) left out
NOT_PORTED = {
    "test_hpa": {
        # the full kubelet's Kubelet and PodStats (A16)
        "TestHPA.test_kubelet_publishes_metrics_end_to_end",
        "TestHPA.test_metrics_cleaned_up_on_pod_teardown",
    },
    "test_attach_csr": {
        # the full kubelet's VolumeManager (A16)
        "TestAttachDetach.test_volume_manager_waits_on_attachment",
        "TestAttachDetach.test_volume_manager_blocks_on_pending_attachment",
    },
}


def _edit(suite: str, src: str) -> str:
    if suite == "test_attach_csr":
        # the module-level import of the VolumeManager (A16) only its two
        # NOT_PORTED cases read
        line = ("from kubernetes_tpu_torch.kubelet.volumemanager "
                "import VolumeManager\n")
        assert line in src
        src = src.replace(line, "")
    if suite == "test_statefulset_daemonset":
        # the port's harness reads JSON copies of the reference's YAML
        # configs and runs its device backend, here on the CPU
        old = ('(Path(__file__).parent.parent / "kubernetes_tpu" / "perf" /\n'
               '           "configs" / "misc.yaml")')
        assert old in src
        src = src.replace(old, '(Path(__file__).parent.parent / '
                          '"kubernetes_tpu_torch" / "perf" /\n'
                          '           "configs" / "misc.json")')
        src = src.replace('name_filter="SchedulingDaemonset")',
                          'name_filter="SchedulingDaemonset", device="cpu")')
    return src


load_suites(globals(), SUITES, NOT_PORTED, _edit)
