"""90th percentile of the program's ``queue`` spans (submit to the first
prefill chunk, wall) of the requests sent in the window."""
from flowbench.readers import pct, span_walls


def read(run):
    return pct(span_walls(run, "queue"), 90)
