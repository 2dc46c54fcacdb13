"""One place that names what is not ported yet and where ROADMAP.md queues it."""

from __future__ import annotations

_ITEMS = {
    8: "plan layer",
    9: "shuffle service",
    10: "relational breadth",
    12: "encoded and compressed columns",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error a caller raises for a branch this port does not carry yet."""
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, item {item} "
        f"({_ITEMS[item]})")
