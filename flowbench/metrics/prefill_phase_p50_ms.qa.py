"""Median wall of the program's ``prefill`` spans (first chunk to the final
chunk's token, which synchronises) of the requests sent in the window."""
from flowbench.readers import pct, span_walls


def read(run):
    p = pct(span_walls(run, "prefill"), 50)
    return None if p is None else 1000.0 * p
