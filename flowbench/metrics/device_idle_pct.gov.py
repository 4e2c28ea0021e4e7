"""Share of the traced slice in which no operation ran on the card: the
union of the profiler's device records."""
from flowbench.readers import idle_pct as read  # noqa: F401
