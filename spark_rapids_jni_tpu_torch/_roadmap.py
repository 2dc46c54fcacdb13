"""One place that names what is not ported yet and where ROADMAP.md queues it."""

from __future__ import annotations

_ITEMS = {
    13: "memory and spill",
    14: "I/O",
    16: "serving fleet",
    17: "tooling edges",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error a caller raises for a branch this port does not carry yet."""
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, item {item} "
        f"({_ITEMS[item]})")
