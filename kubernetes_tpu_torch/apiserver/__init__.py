"""API server layer (cmd/kube-apiserver + staging apiserver equivalent).

A copy of the reference package's module
(kubernetes_tpu/apiserver/__init__.py).
"""

from .server import AdmissionError, APIServer

__all__ = ["APIServer", "AdmissionError"]
