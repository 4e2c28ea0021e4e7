"""Median wall of the program's ``transfer`` spans (the P->D move and its
verify) of the requests sent in the window."""
from flowbench.readers import pct, span_walls


def read(run):
    p = pct(span_walls(run, "transfer"), 50)
    return None if p is None else 1000.0 * p
