"""Median time to first token, from the due time, of the requests sent in the window."""
from flowbench.readers import pct, ttfts


def read(run):
    return pct(ttfts(run), 50)
