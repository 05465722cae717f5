"""CSR approval + signing controllers.

Reference: pkg/controller/certificates/ — the approver
(approver/sarapprove.go) auto-approves kubelet client CSRs whose subject
matches the node-identity shape, and the signer (signer/signer.go) mints
certificates from the cluster CA for approved CSRs of the signers it
handles. Both are standard reconcile loops over CertificateSigningRequest
objects.

A copy of the reference package's module
(kubernetes_tpu/controllers/certificates.py).
"""

from __future__ import annotations

from ..api.certificates import (
    CLIENT_SIGNER,
    CONDITION_APPROVED,
    CONDITION_DENIED,
    KUBELET_CLIENT_SIGNER,
)
from .base import Controller


class CSRApprovingController(Controller):
    """Auto-approve kubelet bootstrap CSRs (the sarapprove model, scoped
    to the node-client signer): the CSR must name the kubelet client
    signer and request a system:node identity. Anything else waits for a
    human/admin approval (kubectl certificate approve)."""

    name = "csrapproving"
    watches = ("CertificateSigningRequest",)

    # the exact usage set sarapprove requires for kubelet client certs
    # (kubeletClientUsages, approver/sarapprove.go) — "key encipherment"
    # is optional there too
    _ALLOWED_USAGES = frozenset(
        {"digital signature", "key encipherment", "client auth"})

    def reconcile(self, key: str) -> None:
        csr = self.store.try_get("CertificateSigningRequest", key)
        if csr is None or csr.status.get("conditions"):
            return  # gone, or already approved/denied
        if csr.spec.signer_name != KUBELET_CLIENT_SIGNER:
            return
        usages = set(csr.spec.usages)
        if "client auth" not in usages or usages - self._ALLOWED_USAGES:
            return  # a serving-cert (or over-broad) request never auto-approves
        if not self._node_identity(csr):
            return
        if (csr.spec.username
                and not csr.spec.username.startswith("system:node:")):
            # the requestor-identity half of sarapprove: only a node (or
            # the bootstrap flow acting as one) may request its own cert
            return
        csr.status.setdefault("conditions", []).append({
            "type": CONDITION_APPROVED,
            "reason": "AutoApproved",
            "message": "kubelet bootstrap client certificate",
        })
        self.store.update(csr, check_version=False)

    @staticmethod
    def _node_identity(csr) -> bool:
        """The approver's subject check, EXACT like sarapprove: the CN
        must be system:node:<name> and the Organization must be exactly
        system:nodes (a substring match would approve
        O=system:nodes-attackers)."""
        import re
        import subprocess
        import tempfile

        try:
            with tempfile.NamedTemporaryFile("w", suffix=".csr") as f:
                f.write(csr.spec.request)
                f.flush()
                out = subprocess.run(
                    ["openssl", "req", "-in", f.name, "-noout", "-subject",
                     "-nameopt", "multiline"],
                    capture_output=True, text=True, check=True,
                )
        except Exception:  # noqa: BLE001 - unparseable = not approvable
            return False
        fields: dict[str, list[str]] = {}
        for line in out.stdout.splitlines():
            m = re.match(r"\s*(\w+)\s*=\s*(.*)$", line)
            if m:
                fields.setdefault(m.group(1), []).append(m.group(2).strip())
        cn = fields.get("commonName", [])
        orgs = fields.get("organizationName", [])
        return (len(cn) == 1 and cn[0].startswith("system:node:")
                and len(cn[0]) > len("system:node:")
                and orgs == ["system:nodes"])


class CSRSigningController(Controller):
    """Sign approved CSRs from the cluster CA (signer/signer.go): only the
    signers this controller handles; denied or unapproved CSRs are left
    alone; the minted certificate lands in status.certificate."""

    name = "csrsigning"
    watches = ("CertificateSigningRequest",)
    SIGNERS = (KUBELET_CLIENT_SIGNER, CLIENT_SIGNER)

    def __init__(self, store, informers=None, clock=None,
                 ca_cert: str = "", ca_key: str = ""):
        super().__init__(store, informers, clock=clock)
        self.ca_cert = ca_cert
        self.ca_key = ca_key

    def reconcile(self, key: str) -> None:
        from ..apiserver.certs import sign_csr

        csr = self.store.try_get("CertificateSigningRequest", key)
        if csr is None or not self.ca_cert:
            return
        if csr.spec.signer_name not in self.SIGNERS:
            return
        if csr.status.get("certificate"):
            return
        conds = {c.get("type") for c in csr.status.get("conditions", ())}
        if CONDITION_DENIED in conds or CONDITION_APPROVED not in conds:
            return
        if "SigningFailed" in conds:
            # one failure report per CSR: re-signing on every reconcile
            # would hot-loop (each status update re-triggers the informer)
            # and grow conditions without bound; the admin clears the
            # condition (or recreates the CSR) to retry
            return
        try:
            cert = sign_csr(csr.spec.request, self.ca_cert, self.ca_key)
        except Exception as e:  # noqa: BLE001 - surfaced on the object
            csr.status.setdefault("conditions", []).append({
                "type": "SigningFailed", "message": str(e)[:300],
            })
            self.store.update(csr, check_version=False)
            return
        csr.status["certificate"] = cert
        self.store.update(csr, check_version=False)
