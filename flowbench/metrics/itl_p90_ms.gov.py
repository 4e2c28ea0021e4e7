"""``itl_p90_ms`` in the closed loop's cell, under a bound of its own: the
90th percentile of the gaps between consecutive output tokens whose later
token came inside the window."""
import pathlib

from flowbench.harness import load_module

read = load_module(pathlib.Path(__file__).with_name("itl_p90_ms.py"),
                   "flowbench_metric_itl_p90_ms").read
