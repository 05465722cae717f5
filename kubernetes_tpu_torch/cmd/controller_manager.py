"""kube-controller-manager binary: the controller set behind one process.

Reference: cmd/kube-controller-manager — flags → controller set on a
shared informer factory, Lease-based leader election (only the leader's
controllers run), /healthz. Controllers run threaded (Controller.run per
controller) while leadership holds; losing the lease stops them.

A copy of the reference package's module
(kubernetes_tpu/cmd/controller_manager.py).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..controllers import ControllerManager, default_controllers


class ControllerManagerServer:
    def __init__(self, store, identity: str = "kcm-0",
                 leader_elect: bool = False):
        self.store = store
        self.identity = identity
        self.leader_elect = leader_elect
        self.manager = ControllerManager(store, default_controllers(store))
        self.elector = None
        self._stop = threading.Event()
        self._run_stop: threading.Event | None = None
        self._http: ThreadingHTTPServer | None = None

    def _build_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/healthz":
                    ok = not server._stop.is_set()
                    body = b"ok" if ok else b"stopping"
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/readyz":
                    leading = (server.elector is None
                               or server.elector.is_leader())
                    body = b"ok" if leading else b"not leader"
                    self.send_response(200 if leading else 503)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *a):
                pass

        return Handler

    def serve(self, port: int = 0) -> int:
        self._http = ThreadingHTTPServer(("127.0.0.1", port),
                                         self._build_handler())
        threading.Thread(target=self._http.serve_forever, daemon=True).start()
        return self._http.server_address[1]

    def _start_controllers(self) -> None:
        if self._run_stop is None:
            self._run_stop = threading.Event()
            self.manager.run(self._run_stop)

    def _stop_controllers(self) -> None:
        if self._run_stop is not None:
            self._run_stop.set()
            self._run_stop = None

    def run(self, block: bool = False) -> None:
        if not self.leader_elect:
            self._start_controllers()
            if block:
                self._stop.wait()
            return
        from ..client.leaderelection import LeaderElector

        self.elector = LeaderElector(
            store=self.store,
            identity=self.identity,
            name="kube-controller-manager",
            on_started_leading=self._start_controllers,
            on_stopped_leading=self._stop_controllers,
        )
        threading.Thread(target=self.elector.run, daemon=True).start()
        if block:
            self._stop.wait()

    def shutdown(self) -> None:
        self._stop.set()
        self._stop_controllers()
        if self.elector is not None:
            self.elector.stop()
        if self._http is not None:
            self._http.shutdown()


def main(argv: list[str] | None = None) -> int:
    import argparse

    from ..client.rest import RESTStore

    parser = argparse.ArgumentParser(description="controller manager")
    parser.add_argument("--server", required=True, help="API server URL")
    parser.add_argument("--token", default="")
    parser.add_argument("--cacert", default=None,
                        help="CA bundle for an https:// server")
    parser.add_argument("--identity", default="kcm-0")
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--port", type=int, default=10257)
    args = parser.parse_args(argv)
    server = ControllerManagerServer(
        RESTStore(args.server, token=args.token,
                  ca_cert=getattr(args, 'cacert', None)),
        identity=args.identity, leader_elect=args.leader_elect,
    )
    server.serve(args.port)
    server.run(block=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
