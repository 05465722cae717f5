"""Cluster bootstrap: the kubeadm-init equivalent.

Reference: cmd/kubeadm brings up a control plane (apiserver, controller
manager, scheduler), mints credentials, and joins nodes. Here the whole
cluster is process-local: `ClusterBootstrap.init()` starts the API server
(optionally with bearer-token authn + RBAC bootstrap policy), the scheduler
loop, the controller manager, per-node hollow kubelets, and a node proxy —
and returns a kubeconfig-shaped dict (server URL + admin token) a client
can use immediately. `kubeadm join` is `add_node()`.

A copy of the reference package's module (kubernetes_tpu/cmd/bootstrap.py).
The port has no host-only profile: the Scheduler always runs the device
backend with the reference's device profile (`Profile(backend="tpu",
wave_size=256)`), on the card unless the caller passes `device="cpu"`,
and without a card it raises rather than fall back. `converge()` keeps
each round's seconds per tier in `round_seconds`.
"""

from __future__ import annotations

import secrets
import threading
import time

from ..apiserver.auth import RBACAuthorizer, TokenAuthenticator, User, bootstrap_policy
from ..apiserver.server import APIServer
from ..controllers import ControllerManager, default_controllers
from ..kubelet import HollowKubelet
from ..proxy import Proxier
from ..scheduler import Scheduler
from ..store.store import Store


class ClusterBootstrap:
    def __init__(self, nodes: int = 3, secure: bool = False, clock=None,
                 store: Store | None = None, tls: bool = False,
                 device="cuda"):
        from ..scheduler.tpu.backend import resolve_device
        from ..utils.clock import Clock

        # no silent fallback: without a card only device="cpu" runs
        self.device = resolve_device(device)
        self.clock = clock or Clock()
        self.store = store or Store()
        self.nodes = nodes
        self.secure = secure
        self.tls = tls  # HTTPS serving (kubeadm's cert phase)
        self.ca_cert: str | None = None
        self._tls_key: str | None = None
        self.admin_token = ""
        self.apiserver: APIServer | None = None
        self.scheduler: Scheduler | None = None
        self.controller_manager: ControllerManager | None = None
        self.kubelets: list[HollowKubelet] = []
        self.proxiers: list[Proxier] = []
        # node name -> (client key path, CA-signed client cert PEM) minted
        # by the CSR join flow (TLS mode)
        self.node_credentials: dict[str, tuple[str, str]] = {}
        # one dict per converge() round: seconds in the controllers, the
        # scheduler, the kubelets, and (last round only) the proxies
        self.round_seconds: list[dict[str, float]] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- phases (kubeadm's init workflow) ------------------------------------

    def init(self, serve_port: int = 0) -> dict:
        """Run all init phases; returns the admin kubeconfig dict."""
        self._phase_certs_and_auth()
        self._phase_control_plane(serve_port)
        self._phase_bootstrap_policy()
        self._phase_join_nodes()
        return self.kubeconfig()

    def _phase_certs_and_auth(self) -> None:
        if self.secure:
            self.admin_token = secrets.token_urlsafe(16)
        if self.tls:
            from ..apiserver.certs import generate_self_signed

            self.ca_cert, self._tls_key = generate_self_signed()

    def _phase_control_plane(self, serve_port: int) -> None:
        authn = authz = None
        if self.secure:
            from ..apiserver.auth import ServiceAccountIssuer

            authn = TokenAuthenticator({
                self.admin_token: User("kubernetes-admin",
                                       ("system:masters",)),
            }, sa_issuer=ServiceAccountIssuer(self.store))
            authz = RBACAuthorizer(self.store)
        from ..apiserver.admission import default_admission_chain

        self.apiserver = APIServer(self.store,
                                   admission=default_admission_chain(self.store),
                                   authenticator=authn, authorizer=authz)
        if self.tls:
            self.apiserver.serve(serve_port, tls_cert=self.ca_cert,
                                 tls_key=self._tls_key)
        else:
            self.apiserver.serve(serve_port)
        from ..scheduler import Profile

        profiles = [Profile(backend="tpu", wave_size=256)]
        self.scheduler = Scheduler(self.store, profiles=profiles,
                                   clock=self.clock, device=self.device)
        self.scheduler.start()  # sync informers before any pods arrive
        self.controller_manager = ControllerManager(
            self.store, default_controllers(
                self.store, clock=self.clock,
                ca_cert=self.ca_cert or "", ca_key=self._tls_key or "",
            )
        )

    def _phase_bootstrap_policy(self) -> None:
        if not self.secure:
            return
        for obj in bootstrap_policy():
            if self.store.try_get(obj.kind, obj.meta.key) is None:
                self.store.create(obj)

    def _phase_join_nodes(self) -> None:
        for i in range(self.nodes):
            self.add_node(f"node-{i}", zone=f"zone-{i % 8}")

    def add_node(self, name: str, cpu: str = "8", mem: str = "32Gi",
                 zone: str = "zone-0") -> HollowKubelet:
        """kubeadm join: register a kubelet + per-node proxy. With TLS on,
        the node's client identity is MINTED through the CSR flow first
        (kubelet bootstrap: CSR → auto-approve → CA-signed cert), not
        pre-shared."""
        from ..testing.wrappers import make_node

        if self.tls:
            self.join_certificate(name)
        kubelet = HollowKubelet(self.store, make_node(name, cpu=cpu, mem=mem,
                                                      zone=zone),
                                clock=self.clock)
        kubelet.register()
        self.kubelets.append(kubelet)
        self.proxiers.append(Proxier(self.store, node_name=name))
        return kubelet

    def join_certificate(self, node_name: str) -> tuple[str, str]:
        """The kubelet TLS-bootstrap half of kubeadm join
        (pkg/kubelet/certificate/bootstrap): generate a key + CSR with the
        node identity (CN=system:node:<name>, O=system:nodes), submit a
        CertificateSigningRequest, drive the approval + signing
        controllers, and return (key_path, signed cert PEM) chained to the
        cluster CA."""
        from ..api.certificates import CertificateSigningRequest, CSRSpec
        from ..api.meta import ObjectMeta
        from ..apiserver.certs import new_key_and_csr

        from ..store.store import NotFoundError

        assert self.controller_manager is not None
        key_path, csr_pem = new_key_and_csr(
            f"system:node:{node_name}", org="system:nodes")
        csr_name = f"node-csr-{node_name}"
        # a re-join replaces any prior CSR: the fresh key needs its OWN
        # signature — returning a cert minted for an older key would hand
        # the node a mismatched key/cert pair
        try:
            self.store.delete("CertificateSigningRequest", csr_name)
        except NotFoundError:
            pass
        self.store.create(CertificateSigningRequest(
            meta=ObjectMeta(name=csr_name, namespace=""),
            spec=CSRSpec(request=csr_pem,
                         username=f"system:node:{node_name}"),
        ))
        # drive approver + signer and WAIT for the certificate: in threaded
        # mode a worker may hold the CSR key mid-reconcile while our
        # sync_once sees an empty queue — polling covers both modes
        import os
        import shutil
        import time as _t

        cert = ""
        deadline = _t.monotonic() + 10.0
        while _t.monotonic() < deadline:
            self.controller_manager.sync_once()
            csr = self.store.get("CertificateSigningRequest", csr_name)
            cert = csr.status.get("certificate", "")
            if cert:
                break
            _t.sleep(0.02)
        if not cert:
            raise RuntimeError(
                f"CSR {csr_name} was not signed: {csr.status}")
        old = self.node_credentials.get(node_name)
        if old is not None:
            # a re-join replaces the key: the superseded key material must
            # not linger on disk
            shutil.rmtree(os.path.dirname(old[0]), ignore_errors=True)
        self.node_credentials[node_name] = (key_path, cert)
        return key_path, cert

    # -- convergence ---------------------------------------------------------

    def converge(self, rounds: int = 10) -> None:
        """Deterministic single-threaded convergence (tests): controllers →
        scheduler → kubelets → proxies until a fixed point."""
        assert self.scheduler is not None and self.controller_manager is not None
        clock = time.perf_counter
        for _ in range(rounds):
            t0 = clock()
            n = self.controller_manager.sync_once()
            t1 = clock()
            n += self.scheduler.schedule_pending()
            t2 = clock()
            for k in self.kubelets:
                n += k.sync_once()
            t3 = clock()
            self.round_seconds.append({"controllers": t1 - t0,
                                       "scheduler": t2 - t1,
                                       "kubelets": t3 - t2, "proxies": 0.0})
            if n == 0:
                break
        t0 = clock()
        for p in self.proxiers:
            p.sync()
        if self.round_seconds:
            self.round_seconds[-1]["proxies"] = clock() - t0

    def run(self) -> None:
        """Threaded mode: every component loops until shutdown()."""
        assert self.controller_manager is not None
        self.controller_manager.run(self._stop)
        for k in self.kubelets:
            self._threads.append(k.run(self._stop))

        def sched_loop():
            while not self._stop.is_set():
                if self.scheduler.schedule_pending() == 0:
                    self._stop.wait(0.01)

        def proxy_loop():
            while not self._stop.is_set():
                for p in self.proxiers:
                    p.sync()
                self._stop.wait(0.05)

        for fn in (sched_loop, proxy_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    # -- client access -------------------------------------------------------

    def kubeconfig(self) -> dict:
        assert self.apiserver is not None
        cfg = {
            "server": self.apiserver.url,
            "token": self.admin_token,
        }
        if self.ca_cert:
            cfg["certificate-authority"] = self.ca_cert
        return cfg

    def client(self):
        from ..client.rest import RESTStore

        cfg = self.kubeconfig()
        return RESTStore(cfg["server"], token=cfg["token"],
                         ca_cert=cfg.get("certificate-authority"))

    def shutdown(self) -> None:
        import os
        import shutil

        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        if self.apiserver is not None:
            self.apiserver.shutdown()
        # private-key material minted by the CSR join flow must not
        # outlive the cluster (each join created one temp dir)
        for key_path, _cert in self.node_credentials.values():
            shutil.rmtree(os.path.dirname(key_path), ignore_errors=True)
        self.node_credentials.clear()


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="cluster bootstrap (kubeadm init)")
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--secure", action="store_true")
    parser.add_argument("--tls", action="store_true",
                        help="serve HTTPS with a generated self-signed cert")
    parser.add_argument("--port", type=int, default=6443)
    parser.add_argument("--device", default="cuda",
                        help="the scheduler's device: cuda, or cpu for the "
                             "kernels' plain PyTorch versions")
    args = parser.parse_args(argv)
    boot = ClusterBootstrap(nodes=args.nodes, secure=args.secure,
                            tls=args.tls, device=args.device)
    cfg = boot.init(serve_port=args.port)
    boot.run()
    print(json.dumps(cfg), flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        boot.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
