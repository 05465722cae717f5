"""certificates.k8s.io — CertificateSigningRequest.

Reference: staging/src/k8s.io/api/certificates/v1/types.go + the signing
controllers in pkg/controller/certificates/ (approver, signer). A client
(kubeadm join's kubelet bootstrap) submits a PEM CSR naming a signer;
an approval controller adds the Approved condition; the signing controller
mints the certificate from the cluster CA into status. Cluster-scoped.

A copy of the reference package's module
(kubernetes_tpu/api/certificates.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta

# the signers the reference's signing controller handles
# (pkg/controller/certificates/signer/signer.go)
KUBELET_CLIENT_SIGNER = "kubernetes.io/kube-apiserver-client-kubelet"
CLIENT_SIGNER = "kubernetes.io/kube-apiserver-client"

CONDITION_APPROVED = "Approved"
CONDITION_DENIED = "Denied"


@dataclass
class CSRSpec:
    request: str = ""  # PEM-encoded PKCS#10 CSR
    signer_name: str = KUBELET_CLIENT_SIGNER
    usages: tuple[str, ...] = ("digital signature", "client auth")
    username: str = ""  # requestor identity (set by the server on create)


@dataclass
class CertificateSigningRequest:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CSRSpec = field(default_factory=CSRSpec)
    # {"certificate": PEM, "conditions": [{"type": ..., "reason": ...}]}
    status: dict = field(default_factory=dict)

    kind = "CertificateSigningRequest"

    def condition(self, ctype: str) -> dict | None:
        for c in self.status.get("conditions", ()):
            if c.get("type") == ctype:
                return c
        return None

    @property
    def approved(self) -> bool:
        return self.condition(CONDITION_APPROVED) is not None

    @property
    def denied(self) -> bool:
        return self.condition(CONDITION_DENIED) is not None
