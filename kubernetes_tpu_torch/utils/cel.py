"""CEL subset: device selection expressions + admission policy expressions.

Reference, two consumers:
- DRA device selection (pkg/scheduler/framework/plugins/dynamicresources/
  dynamicresources.go:637 via staging/src/k8s.io/dynamic-resource-
  allocation/cel/compile.go): predicates over a `device` variable —
      device.driver == "gpu.example.com"
      device.capacity["memory"] >= quantity("40Gi")
- ValidatingAdmissionPolicy (staging/src/k8s.io/apiserver/pkg/admission/
  plugin/policy/validating): predicates over `object` / `oldObject` /
  `request` —
      object.spec.replicas <= 5
      has(object.meta.labels) && object.meta.labels["env"] == "prod"

This module implements exactly that surface: a recursive descent parser
producing a compiled closure, with ==, !=, <, <=, >, >=, &&, ||, !, `in`
over list literals, parentheses, string/int/float/bool literals, the
`quantity()` / `size()` functions and the `has()` presence macro, and
generic variable paths (`<root>(.field | [key])*`) walked over dict
contexts. Compilation is cached per expression.

Security note: expressions are parsed into closures over a fixed AST — no
Python eval, no attribute access beyond the provided context dicts.

A copy of the reference package's module
(kubernetes_tpu/utils/cel.py).
"""

from __future__ import annotations

import re
from typing import Any, Callable

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>-?\d+(?:\.\d+)?)
    | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>==|!=|>=|<=|&&|\|\||[><!()\[\],.])
    )""", re.VERBOSE)


class CELError(ValueError):
    pass


def _tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None or m.end() == pos:
            rest = src[pos:].strip()
            if not rest:
                break
            raise CELError(f"cannot tokenize at: {rest[:20]!r}")
        if m.group("num") is not None:
            out.append(("num", m.group("num")))
        elif m.group("str") is not None:
            s = m.group("str")[1:-1]
            if "\\" in s:
                # resolve backslash escapes only when present — the UTF-8
                # round trip through unicode_escape mangles non-ASCII text
                s = s.encode("latin-1", "backslashreplace").decode("unicode_escape")
            out.append(("str", s))
        elif m.group("ident") is not None:
            out.append(("ident", m.group("ident")))
        else:
            out.append(("op", m.group("op")))
        pos = m.end()
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind: str, value: str | None = None):
        t = self.next()
        if t[0] != kind or (value is not None and t[1] != value):
            raise CELError(f"expected {value or kind}, got {t[1]!r}")
        return t

    # expr := or_expr
    def parse(self) -> Callable[[dict], Any]:
        fn = self.parse_or()
        if self.peek()[0] != "eof":
            raise CELError(f"trailing tokens at {self.peek()[1]!r}")
        return fn

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == ("op", "||"):
            self.next()
            right = self.parse_and()
            left = (lambda l, r: lambda ctx: bool(l(ctx)) or bool(r(ctx)))(left, right)
        return left

    def parse_and(self):
        left = self.parse_unary()
        while self.peek() == ("op", "&&"):
            self.next()
            right = self.parse_unary()
            left = (lambda l, r: lambda ctx: bool(l(ctx)) and bool(r(ctx)))(left, right)
        return left

    def parse_unary(self):
        if self.peek() == ("op", "!"):
            self.next()
            inner = self.parse_unary()
            return lambda ctx: not bool(inner(ctx))
        return self.parse_comparison()

    _CMP = {
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
        ">": lambda a, b: _numeric(a) > _numeric(b),
        ">=": lambda a, b: _numeric(a) >= _numeric(b),
        "<": lambda a, b: _numeric(a) < _numeric(b),
        "<=": lambda a, b: _numeric(a) <= _numeric(b),
    }

    def parse_comparison(self):
        left = self.parse_operand()
        t = self.peek()
        if t[0] == "op" and t[1] in self._CMP:
            op = self._CMP[self.next()[1]]
            right = self.parse_operand()
            return (lambda l, r, op: lambda ctx: op(l(ctx), r(ctx)))(left, right, op)
        if t == ("ident", "in"):
            self.next()
            right = self.parse_operand()
            return (lambda l, r: lambda ctx: l(ctx) in r(ctx))(left, right)
        return left

    def parse_operand(self):
        t = self.peek()
        if t == ("op", "("):
            self.next()
            inner = self.parse_or()
            self.expect("op", ")")
            return inner
        if t == ("op", "["):
            self.next()
            items = []
            while self.peek() != ("op", "]"):
                items.append(self.parse_operand())
                if self.peek() == ("op", ","):
                    self.next()
            self.expect("op", "]")
            return (lambda items: lambda ctx: [f(ctx) for f in items])(items)
        if t[0] == "num":
            self.next()
            val = float(t[1]) if "." in t[1] else int(t[1])
            return lambda ctx, val=val: val
        if t[0] == "str":
            self.next()
            return lambda ctx, val=t[1]: val
        if t[0] == "ident":
            return self.parse_path_or_call()
        raise CELError(f"unexpected token {t[1]!r}")

    def parse_path_or_call(self):
        name = self.next()[1]
        if name == "true":
            return lambda ctx: True
        if name == "false":
            return lambda ctx: False
        if name == "null":
            return lambda ctx: None
        if name == "quantity":
            self.expect("op", "(")
            arg = self.parse_operand()
            self.expect("op", ")")

            def q(ctx, arg=arg):
                from ..api.quantity import parse_quantity

                return parse_quantity(str(arg(ctx)))

            return q
        if name == "size":
            self.expect("op", "(")
            arg = self.parse_operand()
            self.expect("op", ")")

            def sz(ctx, arg=arg):
                v = arg(ctx)
                if v is None:
                    raise CELError("size() of missing value")
                return len(v)

            return sz
        if name == "has":
            # CEL's has() macro: field-presence test; a missing path (or
            # any error walking it) is absence, never an evaluation error
            self.expect("op", "(")
            arg = self.parse_operand()
            self.expect("op", ")")

            def present(ctx, arg=arg):
                try:
                    return arg(ctx) is not None
                except (CELError, TypeError, KeyError):
                    return False

            return present
        # generic variable path: <root>(.field | [key])* over dict contexts
        # (the reference compiles against declared variables — object,
        # oldObject, request, device; an unknown ROOT is a runtime error so
        # admission failurePolicy applies, a missing FIELD is None so
        # comparisons read as non-matching)
        steps: list = []
        while True:
            t = self.peek()
            if t == ("op", "."):
                self.next()
                steps.append(("field", self.expect("ident")[1]))
            elif t == ("op", "["):
                self.next()
                key = self.parse_operand()
                self.expect("op", "]")
                steps.append(("index", key))
            else:
                break

        def walk(ctx, name=name, steps=tuple(steps)):
            if name not in ctx:
                raise CELError(f"unknown variable {name!r}")
            cur = ctx[name]
            for kind, step in steps:
                if cur is None:
                    return None
                key = step if kind == "field" else step(ctx)
                if isinstance(cur, dict):
                    cur = cur.get(key)
                elif isinstance(cur, (list, tuple)) and isinstance(key, int):
                    cur = cur[key] if -len(cur) <= key < len(cur) else None
                else:
                    raise CELError(
                        f"cannot access {key!r} on {type(cur).__name__}"
                    )
            return cur

        return walk


def _numeric(v) -> float:
    if isinstance(v, bool) or v is None:
        raise CELError(f"not numeric: {v!r}")
    if isinstance(v, (int, float)):
        return v
    try:
        return float(v)  # covers numeric strings and Fractions (quantity())
    except (TypeError, ValueError) as e:
        raise CELError(f"not numeric: {v!r}") from e


_compiled: dict[str, Callable[[dict], Any]] = {}


def compile_expression(src: str) -> Callable[[dict], Any]:
    """Compile (with cache) a device selection expression."""
    fn = _compiled.get(src)
    if fn is None:
        fn = _Parser(_tokenize(src)).parse()
        _compiled[src] = fn
    return fn


def evaluate_device(src: str, *, driver: str = "", name: str = "",
                    attributes=None, capacity=None) -> bool:
    """Evaluate an expression against one device; mis-typed comparisons and
    missing attributes evaluate False (the reference treats runtime CEL
    errors as non-matching devices)."""
    # no copies: this runs per candidate device inside the Filter hot loop,
    # and the compiled closures only ever .get() from these mappings
    _empty: dict = {}
    ctx = {"device": {
        "driver": driver,
        "name": name,
        "attributes": attributes if attributes is not None else _empty,
        "capacity": capacity if capacity is not None else _empty,
    }}
    try:
        return bool(compile_expression(src)(ctx))
    except (CELError, TypeError, KeyError, ValueError):
        # compile failures and runtime type errors (e.g. quantity() over a
        # missing attribute) are NON-MATCHES, never scheduler errors — a
        # bad expression must not put the pod on the error-backoff loop
        return False
