"""Share of the decode lanes that were padding: 100 x the sum of
(``lanes`` - ``batch``) over the sum of ``lanes`` of the window's
``decode_step`` spans before the profiler, in granite-4.0-h-small's cell
(pad lanes run on the scratch block and state slot)."""
from flowbench.phases import pad_pct as read  # noqa: F401
