"""CronJob controller.

Reference: pkg/controller/cronjob (cronjob_controllerv2.go syncCronJob):
parse the 5-field cron schedule, mint a Job at each due tick respecting
concurrencyPolicy (Allow runs overlap, Forbid defers while one is active,
Replace kills the running one), honor startingDeadlineSeconds for missed
ticks (too-late ticks are spent, not replayed), cap missed-tick scanning
(the reference's "too many missed start times", limit 100), and
garbage-collect finished jobs past the history limits. The controller
self-requeues at the next schedule time through its clock-aligned delayed
workqueue — no external resync needed.

The cron dialect is the standard 5-field core: "*", exact values, ranges
"a-b", steps "*/n" and "a-b/n" (anchored at the range start, as cron
anchors them), and comma lists. Unsupported syntax raises ValueError.

A copy of the reference package's module
(kubernetes_tpu/controllers/cronjob.py).
"""

from __future__ import annotations

import functools
import time as _time

from ..api.meta import ObjectMeta, OwnerReference, new_uid
from ..api.workloads import CronJob, Job
from ..store import iter_kind, try_delete
from .base import Controller

# (lo, hi) per field: minute, hour, day-of-month, month, day-of-week
_FIELD_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 7))

MAX_MISSED_STARTS = 100  # cronjob_controllerv2.go mostRecentScheduleTime cap


def _parse_field(spec: str, lo: int, hi: int) -> frozenset[int]:
    out: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, s = part.split("/", 1)
            if not s.isdigit() or int(s) <= 0:
                raise ValueError(f"bad cron step {s!r}")
            step = int(s)
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            if not (a.isdigit() and b.isdigit()):
                raise ValueError(f"bad cron range {part!r}")
            start, end = int(a), int(b)
        elif part.isdigit():
            start = int(part)
            # Vixie cron: "N/step" means N..max/step, a bare "N" just N
            end = hi if step > 1 else start
        else:
            raise ValueError(f"unsupported cron field part {part!r}")
        if not (lo <= start <= end <= hi):
            raise ValueError(f"cron value {part!r} outside [{lo},{hi}]")
        # steps anchor at the range start (cron semantics): */5 on
        # day-of-month fires 1,6,11,... — not multiples of 5
        out.update(range(start, end + 1, step))
    return frozenset(out)


@functools.lru_cache(maxsize=1024)
def _parse_schedule(schedule: str):
    """→ (minute, hour, dom, month, dow sets, dom_star, dow_star)."""
    fields = schedule.split()
    if len(fields) != 5:
        raise ValueError(f"bad cron schedule {schedule!r}")
    parsed = [
        _parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _FIELD_RANGES)
    ]
    # day-of-week: both 0 and 7 mean Sunday
    dow = set(parsed[4])
    if 7 in dow:
        dow.discard(7)
        dow.add(0)
    parsed[4] = frozenset(dow)
    # standard cron: when BOTH dom and dow are restricted, a day matches if
    # EITHER does (Vixie + robfig/cron, which the reference controller uses)
    dom_star = fields[2] == "*"
    dow_star = fields[4] == "*"
    return (*parsed, dom_star, dow_star)


def _day_matches(dom_set, dow_set, dom_star, dow_star, tm) -> bool:
    cron_dow = (tm.tm_wday + 1) % 7  # cron: 0=Sunday; tm_wday: 0=Monday
    dom_ok = tm.tm_mday in dom_set
    dow_ok = cron_dow in dow_set
    if not dom_star and not dow_star:
        return dom_ok or dow_ok
    return dom_ok and dow_ok


def cron_due(schedule: str, t: float) -> bool:
    """True when wall-clock minute `t` matches the 5-field schedule."""
    minute, hour, dom, month, dow, dom_star, dow_star = _parse_schedule(schedule)
    tm = _time.gmtime(t)
    return (tm.tm_min in minute and tm.tm_hour in hour
            and tm.tm_mon in month
            and _day_matches(dom, dow, dom_star, dow_star, tm))


def next_due(schedule: str, after: float,
             horizon_s: int = 5 * 366 * 24 * 3600) -> float | None:
    """First minute boundary strictly after `after` matching the schedule.

    Walks DAYS for the date fields and picks from the minute/hour sets
    directly, so even a once-every-4-years schedule (Feb 29) costs a few
    thousand iterations, not millions of per-minute gmtime calls."""
    minute, hour, dom, month, dow, dom_star, dow_star = _parse_schedule(schedule)
    minutes = sorted(minute)
    hours = sorted(hour)
    t = (int(after) // 60 + 1) * 60
    end = after + horizon_s
    day_start = t - (t % 86400)
    while day_start <= end:
        tm = _time.gmtime(day_start)
        if tm.tm_mon in month and _day_matches(dom, dow, dom_star, dow_star, tm):
            for h in hours:
                for m in minutes:
                    cand = day_start + h * 3600 + m * 60
                    if cand >= t:
                        return float(cand)
        day_start += 86400
    return None


class CronJobController(Controller):
    name = "cronjob"
    watches = ("CronJob", "Job")

    clocked_queue = True  # schedule-time self-requeues ride the clock

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "CronJob":
            return obj.meta.key
        for ref in obj.meta.owner_references:
            if ref.kind == "CronJob" and ref.controller:
                return f"{obj.meta.namespace}/{ref.name}"
        return None

    def sweep(self) -> None:
        """Re-enqueue every cronjob (tests / recovery; steady state relies
        on the schedule-time self-requeue below)."""
        for cj in iter_kind(self.store, "CronJob"):
            self.queue.add(cj.meta.key)

    def reconcile(self, key: str) -> None:
        cj = self.store.try_get("CronJob", key)
        if cj is None:
            return
        owned = [j for j in iter_kind(self.store, "Job")
                 if j.meta.namespace == cj.meta.namespace
                 and any(r.kind == "CronJob" and r.name == cj.meta.name
                         and r.controller for r in j.meta.owner_references)]
        active = [j for j in owned if not j.status.completed
                  and j.status.failed <= j.spec.backoff_limit]
        self._gc_history(cj, owned)
        changed = self._update_active(cj, active)
        if cj.spec.suspend:
            if changed:
                self.store.update(cj, check_version=False)
            return
        now = self.clock.now()
        fired, last_tick = self._due_time(cj, now)
        if fired is None:
            if last_tick is not None and (
                cj.status.last_schedule_time or 0
            ) < last_tick:
                # too late to start (deadline) — the tick is SPENT, or the
                # scan would rewalk it every reconcile forever
                cj.status.last_schedule_time = last_tick
                changed = True
            if changed:
                self.store.update(cj, check_version=False)
            self._requeue_at_next_tick(cj, now)
            return
        if cj.spec.concurrency_policy == "Forbid" and active:
            # defer WITHOUT stamping: when the running job finishes, its
            # Job event re-reconciles this cronjob and the missed run
            # starts if still inside the starting deadline (reference
            # behavior; a stamped tick would be lost forever)
            if changed:
                self.store.update(cj, check_version=False)
            self._requeue_at_next_tick(cj, now)
            return
        if cj.spec.concurrency_policy == "Replace":
            for j in active:
                try_delete(self.store, "Job", j.meta.key)
            active = []
        job = self._mint_job(cj, fired)
        self.store.create(job)
        cj.status.last_schedule_time = fired
        cj.status.active = tuple(j.meta.key for j in active) + (job.meta.key,)
        self.store.update(cj, check_version=False)
        self._requeue_at_next_tick(cj, now)

    # -- helpers -------------------------------------------------------------

    def _requeue_at_next_tick(self, cj: CronJob, now: float) -> None:
        nd = next_due(cj.spec.schedule, now)
        if nd is not None:
            self.queue.add_after(cj.meta.key, nd - now + 0.5)

    def _due_time(self, cj: CronJob, now: float) -> tuple[float | None, float | None]:
        """(tick to fire now | None, most recent tick ≤ now | None).

        Scans forward from last_schedule_time, capped at MAX_MISSED_STARTS
        (the reference gives up similarly); past the cap the scan restarts
        from a recent window so a long-suspended cronjob costs O(1)."""
        last = cj.status.last_schedule_time
        start = last if last is not None else (
            cj.meta.creation_timestamp or now - 60
        )
        fired = None
        due = next_due(cj.spec.schedule, start)
        for _ in range(MAX_MISSED_STARTS):
            if due is None or due > now:
                break
            fired = due
            due = next_due(cj.spec.schedule, due)
        else:
            if due is not None and due <= now:
                # too many missed starts: rescan only the last hour
                fired = None
                due = next_due(cj.spec.schedule, now - 3600)
                for _ in range(61):
                    if due is None or due > now:
                        break
                    fired = due
                    due = next_due(cj.spec.schedule, due)
        if fired is None:
            return None, None
        deadline = cj.spec.starting_deadline_seconds
        if deadline is not None and now - fired > deadline:
            return None, fired
        return fired, fired

    def _mint_job(self, cj: CronJob, due: float) -> Job:
        import copy

        return Job(
            meta=ObjectMeta(
                name=f"{cj.meta.name}-{int(due) // 60}",
                namespace=cj.meta.namespace,
                labels=dict(cj.spec.job_template.template.labels),
                owner_references=[OwnerReference(
                    kind="CronJob", name=cj.meta.name,
                    uid=cj.meta.uid or new_uid(), controller=True,
                )],
            ),
            spec=copy.deepcopy(cj.spec.job_template),
        )

    def _update_active(self, cj: CronJob, active: list[Job]) -> bool:
        want = tuple(sorted(j.meta.key for j in active))
        if tuple(sorted(cj.status.active)) != want:
            cj.status.active = want
            return True
        return False

    def _gc_history(self, cj: CronJob, owned: list[Job]) -> None:
        done = sorted(
            (j for j in owned if j.status.completed),
            key=lambda j: j.status.completion_time or 0,
        )
        failed = sorted(
            (j for j in owned if not j.status.completed
             and j.status.failed > j.spec.backoff_limit),
            key=lambda j: j.meta.creation_timestamp,
        )
        for j in done[: max(0, len(done) - cj.spec.successful_jobs_history_limit)]:
            try_delete(self.store, "Job", j.meta.key)
        for j in failed[: max(0, len(failed) - cj.spec.failed_jobs_history_limit)]:
            try_delete(self.store, "Job", j.meta.key)
