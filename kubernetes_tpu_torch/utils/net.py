"""Hollow-network address assignment.

Real kubelets get pod IPs from CNI; hollow nodes synthesize them. Addresses
must be (a) stable across processes for the same pod uid (the endpointslice
controller and the kubelet must agree without coordination), and (b) outside
the service-VIP range so a pod can't shadow a ClusterIP. We use the upper
half of 10/8 — 10.128.0.0/9, the conventional pod CIDR — keyed by a 23-bit
crc32 of the uid. Collisions are possible (birthday bound ≈ n²/2²⁴) but
merely merge two backends in a slice; VIPs conventionally live in
10.0.0.0/16 and can never collide with this range.

A copy of the reference package's module
(kubernetes_tpu/utils/net.py).
"""

from __future__ import annotations

import zlib


def stable_pod_ip(uid: str) -> str:
    h = zlib.crc32(uid.encode()) & 0x7FFFFF  # 23 bits
    return f"10.{128 + (h >> 16)}.{(h >> 8) & 0xFF}.{h & 0xFF}"
