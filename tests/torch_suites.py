"""Run the reference's own test suites on the port.

Each suite (tests/<suite>.py) is read, its imports of the reference
package turned into the port's (`tests.wrappers` into
`kubernetes_tpu_torch.testing.wrappers`), given the port's device rule
(the entry points run the card unless asked for the CPU, so every
Scheduler, SchedulerServer and ClusterBootstrap the suites build takes
`device="cpu"`) and executed into the loading test module, so every case
of the suite is collected there as a case of the port. A loader lists the
cases that need a module the port does not have yet in its NOT_PORTED;
those are left out.
"""

from __future__ import annotations

import re
from pathlib import Path

from kubernetes_tpu_torch.store import iter_kind, try_delete

TESTS = Path(__file__).resolve().parent


def translate(src: str) -> str:
    """The rewrites every suite takes."""
    src = re.sub(r"\bkubernetes_tpu\.", "kubernetes_tpu_torch.", src)
    src = src.replace("from tests.wrappers import",
                      "from kubernetes_tpu_torch.testing.wrappers import")
    # the port's Scheduler runs its device backend; on the CPU it is asked
    # for the plain versions
    src = re.sub(r"\b(Scheduler\((?:store|client)(?:, profiles=\[[^\]]*\])?)\)",
                 r'\1, device="cpu")', src)
    src = re.sub(r"\bSchedulerServer\(Store\(\), SchedulerConfiguration\(\)\)",
                 'SchedulerServer(Store(), SchedulerConfiguration(), '
                 'device="cpu")', src)
    src = src.replace("ClusterBootstrap(", 'ClusterBootstrap(device="cpu", ')
    # the port's Store keeps the reference's iter_kind and try_delete as
    # helpers beside it (store/__init__.py)
    src = re.sub(r"\b([\w.]+)\.iter_kind\(", r"_iter_kind(\1, ", src)
    src = re.sub(r"\b([\w.]+)\.try_delete\(", r"_try_delete(\1, ", src)
    return src


def load_suites(g: dict, suites, not_ported: dict, edit=None) -> None:
    """Execute each suite into the namespace `g` (a test module's
    globals()); `edit(suite, src)` adds a loader's own rewrites."""
    for suite in suites:
        src = translate((TESTS / f"{suite}.py").read_text())
        if edit is not None:
            src = edit(suite, src)
        ns: dict = {"__name__": f"{g['__name__']}.{suite}",
                    "__file__": g["__file__"],
                    "_iter_kind": iter_kind, "_try_delete": try_delete}
        exec(compile(src, str(TESTS / f"{suite}.py"), "exec"), ns)
        skip = set(not_ported.get(suite, ()))
        for name, obj in ns.items():
            if not name.startswith(("Test", "test_")):
                # fixtures and helpers; a suite's own cases read theirs
                # from the suite's namespace
                if not name.startswith("__"):
                    g.setdefault(name, obj)
                continue
            assert name not in g, f"{suite}: {name} collides"
            if isinstance(obj, type):
                for case in list(skip):
                    cls, _, meth = case.partition(".")
                    if cls == name:
                        delattr(obj, meth)
                        skip.discard(case)
            elif name in skip:
                skip.discard(name)
                continue
            g[name] = obj
        assert not skip, f"{suite}: NOT_PORTED names no case: {skip}"
