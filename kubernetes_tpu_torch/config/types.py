"""Profile validation: the per-profile checks of the reference's
KubeSchedulerConfiguration.validate (kubernetes_tpu/config/types.py:75-81;
pkg/scheduler/apis/config/validation/validation.go).

The port has no versioned configuration document yet; the Scheduler runs
these checks over the Profiles it is given and raises on the first list of
errors.
"""

from __future__ import annotations

# the port's profiles all run on its device backend; the reference's
# "host" backend is not a profile of the port
BACKENDS = ("tpu",)


def validate_profile(profile) -> list[str]:
    """Errors of one scheduler Profile (name, backend, wave_size,
    percentage_of_nodes_to_score); empty when it is valid."""
    errs = []
    name = profile.name
    if profile.backend not in BACKENDS:
        errs.append(f"profile {name}: unknown backend {profile.backend}")
    if profile.wave_size < 0:
        errs.append(f"profile {name}: waveSize must be >= 0")
    pct = profile.percentage_of_nodes_to_score
    if pct is not None and not 0 <= pct <= 100:
        errs.append(f"profile {name}: percentageOfNodesToScore out of range")
    return errs


def validate_profiles(profiles) -> list[str]:
    """Errors of a profile list: each profile's, and duplicate names."""
    errs = []
    names = [p.name for p in profiles]
    if len(names) != len(set(names)):
        errs.append("profile schedulerNames must be unique")
    for p in profiles:
        errs.extend(validate_profile(p))
    return errs
