"""kube-proxy binary equivalent: per-node proxy server.

Reference: cmd/kube-proxy (Options → ProxyServer → Proxier.SyncLoop) — the
server wires a Proxier to the API store, runs the periodic sync loop, and
serves /healthz (reporting whether the last sync is recent, the reference's
healthcheck server semantics, pkg/proxy/healthcheck/) and /rules (debug dump
of the programmed dataplane — the analogue of `iptables-save` output).

A copy of the reference package's module
(kubernetes_tpu/cmd/proxy.py).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..proxy import Proxier
from ..store.store import Store


class ProxyServer:
    def __init__(self, store: Store, node_name: str = "",
                 sync_period_s: float = 1.0):
        self.proxier = Proxier(store, node_name=node_name)
        self.sync_period_s = sync_period_s
        self.last_sync: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._http: ThreadingHTTPServer | None = None

    # -- serving -------------------------------------------------------------

    def _build_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: str, ctype="text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    last = server.last_sync
                    healthy = (last is not None and
                               time.monotonic() - last < 2 * server.sync_period_s + 5)
                    self._send(200 if healthy else 503,
                               "ok" if healthy else "stale")
                elif self.path == "/rules":
                    rules = server.proxier.dataplane.rules()
                    dump = {
                        f"{vip}:{port}/{proto}": {
                            "service": r.service,
                            "backends": [f"{b.address}:{b.port}" for b in r.backends],
                            "sessionAffinity": r.session_affinity,
                        }
                        for (vip, port, proto), r in sorted(rules.items())
                    }
                    self._send(200, json.dumps(dump, indent=1), "application/json")
                else:
                    self._send(404, "not found")

            def log_message(self, *a):
                pass

        return Handler

    def serve(self, port: int = 0) -> int:
        self._http = ThreadingHTTPServer(("127.0.0.1", port), self._build_handler())
        threading.Thread(target=self._http.serve_forever, daemon=True).start()
        return self._http.server_address[1]

    # -- sync loop (Proxier.SyncLoop) ----------------------------------------

    def sync_once(self) -> int:
        n = self.proxier.sync()
        self.last_sync = time.monotonic()
        return n

    def run(self, block: bool = False) -> None:
        def loop():
            while not self._stop.is_set():
                self.sync_once()
                self._stop.wait(self.sync_period_s)

        if block:
            loop()
        else:
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._http is not None:
            self._http.shutdown()


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="node service proxy")
    parser.add_argument("--node", default="")
    parser.add_argument("--server", required=True, help="API server URL")
    parser.add_argument("--token", default="", help="bearer token")
    parser.add_argument("--cacert", default=None,
                        help="CA bundle for an https:// server")
    parser.add_argument("--port", type=int, default=10256)
    parser.add_argument("--sync-period", type=float, default=1.0)
    args = parser.parse_args(argv)
    from ..client.rest import RESTStore

    store = RESTStore(args.server, token=args.token,
                      ca_cert=getattr(args, 'cacert', None))
    server = ProxyServer(store, node_name=args.node,
                         sync_period_s=args.sync_period)
    server.serve(args.port)
    server.run(block=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
