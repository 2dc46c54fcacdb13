"""Plan-time decisions; only the adaptive round bounds are ported so far
(the plan IR and compiler are ROADMAP.md queue 1, item 8)."""
