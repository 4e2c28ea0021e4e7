"""Share of the traced slice in which no operation ran on the card, in
granite-4.0-h-small's cell."""
from flowbench.readers import idle_pct as read  # noqa: F401
