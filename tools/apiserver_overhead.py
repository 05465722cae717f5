"""Where a create through the port's API server spends its time, on the
host that runs it.

    python3 tools/apiserver_overhead.py

Times, per object over 1000 of SchedulingBasic's nodes: the codec's
stages one by one (encode, json.dumps, json.loads, decode), the default
admission chain, Store.create, then a whole create through RESTStore and
an empty GET /healthz against an APIServer on 127.0.0.1, and the create
rate with 1, 4 and 8 client threads. No card is needed; chip_smoke's
phase 33 reads the same rates end to end.
"""

import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kubernetes_tpu_torch.api.serialization import decode, encode  # noqa: E402
from kubernetes_tpu_torch.apiserver import APIServer  # noqa: E402
from kubernetes_tpu_torch.apiserver.admission import default_admission_chain  # noqa: E402
from kubernetes_tpu_torch.client.rest import RESTStore  # noqa: E402
from kubernetes_tpu_torch.store import Store  # noqa: E402
from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node  # noqa: E402

N = 1000


def us(t0):
    return (time.perf_counter() - t0) / N * 1e6


def main() -> int:
    objs = [scheduling_basic_node(i) for i in range(N)]
    t = time.perf_counter()
    enc = [encode(o) for o in objs]
    print(f"encode us {us(t):.1f}")
    t = time.perf_counter()
    txt = [json.dumps(e) for e in enc]
    print(f"dumps us {us(t):.1f}")
    t = time.perf_counter()
    dd = [json.loads(x) for x in txt]
    print(f"loads us {us(t):.1f}")
    t = time.perf_counter()
    dec = [decode(x) for x in dd]
    print(f"decode us {us(t):.1f}")
    store = Store()
    adm = default_admission_chain(store)
    t = time.perf_counter()
    for o in dec:
        for a in adm:
            a("CREATE", o)
    print(f"admission us {us(t):.1f}")
    t = time.perf_counter()
    for o in dec:
        store.create(o)
    print(f"store.create us {us(t):.1f}")
    for n in (1, 4, 8):
        st = Store()
        sv = APIServer(st, admission=default_admission_chain(st))
        sv.serve(0)
        try:
            if n == 1:
                c = RESTStore(sv.url)
                t = time.perf_counter()
                for o in objs:
                    c.create(o)
                print(f"REST create us {us(t):.1f}")
                t = time.perf_counter()
                for _ in range(N):
                    urllib.request.urlopen(sv.url + "/healthz").read()
                print(f"GET /healthz us {us(t):.1f}")
                st, sv2 = Store(), sv
                sv = APIServer(st, admission=default_admission_chain(st))
                sv.serve(0)
                sv2.shutdown()

            def work(k, url=sv.url, n=n):
                cl = RESTStore(url)
                for o in objs[k::n]:
                    cl.create(o)

            ts = [threading.Thread(target=work, args=(k,)) for k in range(n)]
            t = time.perf_counter()
            for x in ts:
                x.start()
            for x in ts:
                x.join()
            print(f"{n} client threads: {N / (time.perf_counter() - t):.1f} creates/s")
        finally:
            sv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
