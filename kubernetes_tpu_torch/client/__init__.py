"""Client runtime: shared informers over the store.

Reference: staging/src/k8s.io/client-go tools/cache (Reflector, DeltaFIFO,
SharedIndexInformer). A copy of the reference package's informer
(kubernetes_tpu/client/informer.py); its workqueue and leader election are
not copied.
"""

from .informer import InformerFactory, SharedInformer  # noqa: F401
