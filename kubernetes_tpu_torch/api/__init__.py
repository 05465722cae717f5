"""Typed object core: the Pod/Node subset the wave path schedules.

Quantities are canonicalized to integer plane units (CPU millicores, memory
MiB) at parse time, exactly as in the reference package, so both packages
build the same planes from the same objects.
"""
