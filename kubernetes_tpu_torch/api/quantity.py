"""Resource quantity parsing, canonicalized to integer plane units.

Reference: staging/src/k8s.io/apimachinery/pkg/api/resource (Quantity). We do
not keep an arbitrary-precision Quantity around: every quantity is parsed once
into an integer in its resource's canonical *plane unit*:

- cpu:               millicores (1 core = 1000)
- memory / storage:  MiB (requests rounded up, capacities rounded down)
- pods / counts:     whole units
- extended/scalar:   whole units (devices), rounded up for requests

This is a deliberate divergence from the reference (which carries int64
byte/milli values everywhere): int32 MiB planes cover 2 PiB per node, keep
all fit/score arithmetic exact in int32 on the device, and guarantee the
host side and the device kernels see the *same* numbers.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

# Decimal and binary SI suffixes, as in apimachinery's Quantity.
_SUFFIX: dict[str, Fraction] = {
    "": Fraction(1),
    "m": Fraction(1, 1000),
    "k": Fraction(10**3),
    "M": Fraction(10**6),
    "G": Fraction(10**9),
    "T": Fraction(10**12),
    "P": Fraction(10**15),
    "E": Fraction(10**18),
    "Ki": Fraction(2**10),
    "Mi": Fraction(2**20),
    "Gi": Fraction(2**30),
    "Ti": Fraction(2**40),
    "Pi": Fraction(2**50),
    "Ei": Fraction(2**60),
}

_MIB = Fraction(2**20)


@lru_cache(maxsize=4096)
def _parse(s: str | int | float) -> Fraction:
    """Memoized: clusters use a handful of distinct quantity strings across
    millions of parses (every PodInfo/NodeInfo build); Fraction results are
    immutable so sharing is safe."""
    if isinstance(s, (int, float)):
        return Fraction(s).limit_denominator(10**9)
    s = s.strip()
    if not s:
        raise ValueError("empty quantity")
    # split numeric part from suffix
    i = len(s)
    while i > 0 and not (s[i - 1].isdigit() or s[i - 1] == "."):
        i -= 1
    num, suffix = s[:i], s[i:]
    if suffix.startswith("e") or suffix.startswith("E"):
        # scientific notation like 1e3
        return Fraction(float(s))
    if suffix not in _SUFFIX:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {s!r}")
    if not num:
        raise ValueError(f"no digits in quantity {s!r}")
    return Fraction(num) * _SUFFIX[suffix]


def parse_quantity(s: str | int | float) -> Fraction:
    """Parse a k8s-style quantity string into an exact Fraction of base units."""
    return _parse(s)


def parse_cpu(s: str | int | float) -> int:
    """CPU quantity -> millicores (rounded up; '100m' -> 100, '2' -> 2000)."""
    v = _parse(s) * 1000
    return -((-v.numerator) // v.denominator)  # ceil


def parse_mem_mib(s: str | int | float, *, floor: bool = False) -> int:
    """Memory/storage quantity -> MiB.

    Requests round *up* (a pod asking for 100M=95.37MiB occupies 96MiB) and
    capacities round *down*, so the plane-unit arithmetic is conservative in
    both directions.
    """
    v = _parse(s) / _MIB
    if floor:
        return v.numerator // v.denominator
    return -((-v.numerator) // v.denominator)


def parse_count(s: str | int | float, *, floor: bool = False) -> int:
    """Whole-unit quantity (pods, devices). Requests ceil, capacities floor."""
    v = _parse(s)
    if floor:
        return v.numerator // v.denominator
    return -((-v.numerator) // v.denominator)
