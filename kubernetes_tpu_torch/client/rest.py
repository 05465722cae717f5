"""REST client: the store interface over HTTP against an APIServer.

Reference: staging/src/k8s.io/client-go/rest + kubernetes typed clientsets.
RESTStore implements the same surface as store.Store (create/get/update/
delete/list/watch), so informers, controllers, and the scheduler can run
in a separate process from the API server without code changes — the
client-go role in the reference's distributed control plane (SURVEY.md §5.8).

A copy of the reference package's module (kubernetes_tpu/client/rest.py).
Like the reference's, RESTStore has no bind_pods (ROADMAP C19).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from collections import deque

from ..api.serialization import decode, encode
from ..store.store import (
    AlreadyExistsError,
    ConflictError,
    Event,
    NotFoundError,
)


class RESTError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class ApplyConflictError(ConflictError):
    """Server-side apply field-OWNERSHIP conflict (reason
    FieldManagerConflict) — needs --force-conflicts, unlike a plain CAS
    Conflict which just needs a retry."""


def _raise_for(code: int, message: str, reason: str = ""):
    if code == 404:
        raise NotFoundError(message)
    if code == 409:
        if reason == "AlreadyExists":
            raise AlreadyExistsError(message)
        if reason == "FieldManagerConflict":
            raise ApplyConflictError(message)
        raise ConflictError(message)
    raise RESTError(code, message)


class RESTWatch:
    """A streaming watch connection (client-go watch.Interface shape,
    drop-in for store.Watch)."""

    def __init__(self, url: str, headers: dict[str, str] | None = None,
                 binary: bool = False, ssl_context=None):
        self._events: deque[Event] = deque()
        self._cond = threading.Condition()
        self._stopped = False
        self._binary = binary
        req = urllib.request.Request(url, headers=headers or {})
        self._resp = urllib.request.urlopen(  # noqa: S310 - loopback
            req, context=ssl_context
        )
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self) -> None:
        try:
            if self._binary:
                self._read_cbor_frames()
            else:
                for line in self._resp:
                    line = line.strip()
                    if not line:
                        continue
                    self._push_frame(json.loads(line))
        except Exception:  # noqa: BLE001 - connection torn down
            pass
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def _read_cbor_frames(self) -> None:
        from ..api import cbor

        read = self._resp.read
        while True:
            head = read(4)
            if len(head) < 4:
                return
            n = int.from_bytes(head, "big")
            if n == 0:
                continue  # heartbeat
            payload = b""
            while len(payload) < n:
                chunk = read(n - len(payload))
                if not chunk:
                    return
                payload += chunk
            self._push_frame(cbor.loads(payload))

    def _push_frame(self, frame: dict) -> None:
        ev = Event(frame["type"], decode(frame["object"]),
                   frame.get("revision", 0))
        with self._cond:
            self._events.append(ev)
            self._cond.notify_all()

    def next(self, timeout: float | None = None) -> Event | None:
        with self._cond:
            if not self._events and not self._stopped:
                self._cond.wait(timeout)
            return self._events.popleft() if self._events else None

    def drain(self) -> list[Event]:
        with self._cond:
            out = list(self._events)
            self._events.clear()
            return out

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        # shut the socket down FIRST: close() alone deadlocks against the
        # reader thread blocked inside a buffered read on the same fp
        import socket as _socket

        try:
            sock = self._resp.fp.raw._sock  # noqa: SLF001
            sock.shutdown(_socket.SHUT_RDWR)
        except Exception:  # noqa: BLE001
            pass
        self._thread.join(timeout=2)
        try:
            self._resp.close()
        except Exception:  # noqa: BLE001
            pass

    @property
    def stopped(self) -> bool:
        return self._stopped


class RESTStore:
    """Typed client over the API server; same surface as store.Store."""

    def __init__(self, base_url: str, timeout: float = 10.0,
                 token: str = "", wire_format: str = "json",
                 ca_cert: str | None = None):
        """wire_format="cbor" negotiates the binary serializer both ways
        (request bodies, responses, and watch frames) — the protobuf role
        in the reference's content-type negotiation. ca_cert: PEM bundle
        to verify an HTTPS apiserver against (rest.Config.TLSClientConfig
        CAFile) — required for https:// base URLs."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token  # bearer credential (rest.Config.BearerToken)
        self.wire_format = wire_format
        self._ssl = None
        if ca_cert:
            import ssl as _ssl

            self._ssl = _ssl.create_default_context(cafile=ca_cert)

    # -- plumbing ------------------------------------------------------------

    def _headers(self) -> dict[str, str]:
        if self.wire_format == "cbor":
            headers = {"Content-Type": "application/cbor",
                       "Accept": "application/cbor"}
        else:
            headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    def _encode_body(self, body: dict) -> bytes:
        if self.wire_format == "cbor":
            from ..api import cbor

            return cbor.dumps(body)
        return json.dumps(body).encode()

    def _decode_body(self, raw: bytes, ctype: str) -> dict:
        if not raw:
            return {}
        if "application/cbor" in ctype:
            from ..api import cbor

            return cbor.loads(raw)
        return json.loads(raw.decode())

    def _request(self, method: str, path: str, body: dict | None = None) -> dict:
        return self._request_with_status(method, path, body)[0]

    def _request_with_status(
        self, method: str, path: str, body: dict | None = None
    ) -> tuple[dict, int]:
        data = self._encode_body(body) if body is not None else None
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=data, method=method,
            headers=self._headers(),
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self._ssl) as resp:
                return self._decode_body(
                    resp.read(), resp.headers.get("Content-Type") or ""
                ), resp.status
        except urllib.error.HTTPError as e:
            raw = e.read()
            reason = ""
            try:
                status = self._decode_body(
                    raw, e.headers.get("Content-Type") or ""
                )
                message = status.get("message", "")
                reason = status.get("reason", "")
            except (json.JSONDecodeError, ValueError):
                message = raw.decode(errors="replace")
            _raise_for(e.code, message, reason)

    def raw_get(self, path: str) -> dict:
        """GET an arbitrary server path (aggregated APIs under /apis/...,
        discovery documents) — the typed surface below covers only core-v1
        kinds the scheme decodes."""
        return self._request("GET", path)

    # -- store surface -------------------------------------------------------

    def create(self, obj):
        out = self._request("POST", f"/api/v1/{obj.kind}", encode(obj))
        return decode(out)

    def get(self, kind: str, key: str):
        return decode(self._request("GET", f"/api/v1/{kind}/{key}"))

    def try_get(self, kind: str, key: str):
        try:
            return self.get(kind, key)
        except NotFoundError:
            return None

    def contains(self, kind: str, key: str) -> bool:
        """Existence check (Store.contains parity) — over the wire this is
        a GET; the copy-free fast path only exists on the in-process store."""
        return self.try_get(kind, key) is not None

    def update(self, obj, *, check_version: bool = True):
        suffix = "" if check_version else "?force=true"
        out = self._request(
            "PUT", f"/api/v1/{obj.kind}/{obj.meta.key}{suffix}", encode(obj)
        )
        return decode(out)

    def delete(self, kind: str, key: str):
        return decode(self._request("DELETE", f"/api/v1/{kind}/{key}"))

    def patch(self, kind: str, key: str, patch: dict):
        """RFC 7386 JSON merge patch; returns the updated object."""
        out = self._request("PATCH", f"/api/v1/{kind}/{key}", patch)
        return decode(out)

    def apply(self, kind: str, key: str, config: dict,
              field_manager: str, force: bool = False):
        """Server-side apply (fieldmanager): create-or-merge `config` with
        per-field ownership; raises ConflictError when a field is owned by
        another manager (force=True transfers it). Sets
        `last_apply_created` (True when the apply created the object —
        HTTP 201 vs 200) for callers that report it."""
        from urllib.parse import quote

        q = (f"?fieldManager={quote(field_manager, safe='')}"
             + ("&force=true" if force else ""))
        out, code = self._request_with_status(
            "PATCH", f"/api/v1/{kind}/{key}{q}", config
        )
        self.last_apply_created = code == 201
        return decode(out)

    def pod_logs(self, key: str, container: str = "",
                 tail_lines: int | None = None) -> str:
        """GET pods/log subresource (apiserver proxies to the kubelet)."""
        q = []
        if container:
            q.append(f"container={container}")
        if tail_lines is not None:
            q.append(f"tailLines={tail_lines}")
        path = f"/api/v1/Pod/{key}/log" + ("?" + "&".join(q) if q else "")
        req = urllib.request.Request(
            f"{self.base_url}{path}", headers=self._headers())
        try:
            with urllib.request.urlopen(req, timeout=self.timeout,
                                        context=self._ssl) as resp:
                return resp.read().decode()
        except urllib.error.HTTPError as e:
            _raise_for(e.code, e.read().decode(errors="replace"), "")

    def try_delete(self, kind: str, key: str):
        """delete() tolerant of already-gone objects (Store.try_delete)."""
        try:
            return self.delete(kind, key)
        except NotFoundError:
            return None

    @staticmethod
    def _selector_query(label_selector: str, field_selector: str) -> str:
        from urllib.parse import quote

        q = ""
        if label_selector:
            q += f"&labelSelector={quote(label_selector)}"
        if field_selector:
            q += f"&fieldSelector={quote(field_selector)}"
        return q

    def list(self, kind: str, label_selector: str = "",
             field_selector: str = ""):
        sel = self._selector_query(label_selector, field_selector)
        out = self._request("GET", f"/api/v1/{kind}?{sel.lstrip('&')}"
                            if sel else f"/api/v1/{kind}")
        items = [decode(item) for item in out.get("items", [])]
        return items, out.get("metadata", {}).get("resourceVersion", 0)

    def watch(self, kind: str, from_revision: int = 0,
              label_selector: str = "", field_selector: str = "") -> RESTWatch:
        from ..store.store import CompactedError

        sel = self._selector_query(label_selector, field_selector)
        try:
            return RESTWatch(
                f"{self.base_url}/api/v1/{kind}"
                f"?watch=1&resourceVersion={from_revision}{sel}",
                headers=self._headers(),
                binary=self.wire_format == "cbor",
                ssl_context=self._ssl,
            )
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise CompactedError(from_revision, -1) from e
            raise

    def bind(self, pod_key: str, node_name: str) -> None:
        self._request(
            "POST", f"/api/v1/Pod/{pod_key}/binding", {"target_node": node_name}
        )

    # convenience parity with Store
    def pods(self):
        return self.list("Pod")[0]

    def nodes(self):
        return self.list("Node")[0]

    def iter_kind(self, kind: str):
        return iter(self.list(kind)[0])
