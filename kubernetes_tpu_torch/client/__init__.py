"""Client runtime: shared informers over the store.

Reference: staging/src/k8s.io/client-go tools/cache (Reflector, DeltaFIFO,
SharedIndexInformer) and util/workqueue. Copies of the reference package's
informer, workqueue and leader election (kubernetes_tpu/client/informer.py,
workqueue.py, leaderelection.py).
"""

from .informer import InformerFactory, SharedInformer  # noqa: F401
from .workqueue import WorkQueue  # noqa: F401
