"""Serving certificates: kubeadm's cert phase, openssl-binary form.

Reference: kubeadm's `init` generates a self-signed CA and an apiserver
serving certificate with localhost SANs (cmd/kubeadm/app/phases/certs);
the apiserver serves TLS with it and clients verify against the CA from
their kubeconfig. Here one self-signed certificate plays both roles (it
IS its own CA), generated with the system openssl binary — no third-party
Python crypto dependency.

A copy of the reference package's module
(kubernetes_tpu/apiserver/certs.py).
"""

from __future__ import annotations

import os
import subprocess
import tempfile


def generate_self_signed(common_name: str = "kube-apiserver",
                         directory: str | None = None,
                         days: int = 365) -> tuple[str, str]:
    """(cert_path, key_path) for a self-signed serving cert with
    localhost/127.0.0.1 SANs. The cert doubles as the client's CA."""
    directory = directory or tempfile.mkdtemp(prefix="kube-tpu-certs-")
    cert = os.path.join(directory, "apiserver.crt")
    key = os.path.join(directory, "apiserver.key")
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", cert, "-days", str(days),
            "-subj", f"/CN={common_name}",
            "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
        ],
        check=True, capture_output=True,
    )
    os.chmod(key, 0o600)
    return cert, key


def new_key_and_csr(common_name: str, org: str = "",
                    directory: str | None = None) -> tuple[str, str]:
    """(key_path, csr_pem): a fresh RSA key + PKCS#10 CSR — what kubeadm
    join's kubelet bootstrap generates before submitting a
    CertificateSigningRequest (node identities use
    CN=system:node:<name>, O=system:nodes)."""
    directory = directory or tempfile.mkdtemp(prefix="kube-tpu-csr-")
    key = os.path.join(directory, "client.key")
    csr = os.path.join(directory, "client.csr")
    subj = f"/CN={common_name}" + (f"/O={org}" if org else "")
    subprocess.run(
        ["openssl", "req", "-new", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", csr, "-subj", subj],
        check=True, capture_output=True,
    )
    os.chmod(key, 0o600)
    with open(csr) as f:
        return key, f.read()


def sign_csr(csr_pem: str, ca_cert: str, ca_key: str,
             days: int = 365) -> str:
    """Certificate PEM for a CSR, signed by the cluster CA (the signing
    controller's openssl-binary form of
    pkg/controller/certificates/signer)."""
    with tempfile.TemporaryDirectory(prefix="kube-tpu-sign-") as d:
        csr_path = os.path.join(d, "req.csr")
        out_path = os.path.join(d, "out.crt")
        with open(csr_path, "w") as f:
            f.write(csr_pem)
        subprocess.run(
            ["openssl", "x509", "-req", "-in", csr_path,
             "-CA", ca_cert, "-CAkey", ca_key, "-CAcreateserial",
             "-out", out_path, "-days", str(days)],
            check=True, capture_output=True,
        )
        with open(out_path) as f:
            return f.read()


def verify_cert_chain(cert_pem: str, ca_cert: str) -> bool:
    """Does this certificate chain to the CA? (openssl verify)."""
    with tempfile.TemporaryDirectory(prefix="kube-tpu-verify-") as d:
        path = os.path.join(d, "check.crt")
        with open(path, "w") as f:
            f.write(cert_pem)
        out = subprocess.run(
            ["openssl", "verify", "-CAfile", ca_cert, path],
            capture_output=True,
        )
        return out.returncode == 0
