"""90th percentile of the gaps between consecutive output tokens, every
request's, whose later token came inside the window."""
from flowbench.readers import itl_gaps, pct


def read(run):
    p = pct(itl_gaps(run), 90)
    return None if p is None else 1000.0 * p
