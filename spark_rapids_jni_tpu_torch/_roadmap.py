"""One place that names what is not ported yet and where ROADMAP.md queues it."""

from __future__ import annotations

from typing import Union

_ITEMS = {
    16: "serving fleet",
    "16d": "the serving fleet's autoscaling, quotas, result cache and "
           "crash adoption",
    17: "tooling edges",
}


def not_ported(what: str, item: Union[int, str]) -> NotImplementedError:
    """The error a caller raises for a branch this port does not carry yet."""
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, item {item} "
        f"({_ITEMS[item]})")
