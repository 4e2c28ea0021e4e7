"""``transfer_p50_ms.qa``'s reading in granite-4.0-h-small's cell: the median
wall of the ``transfer`` spans (the page plan, the state slot's copy and the
pages' verify) of the requests sent in the window."""
import pathlib

from flowbench.harness import load_module

read = load_module(pathlib.Path(__file__).with_name("transfer_p50_ms.qa.py"),
                   "flowbench_metric_transfer_p50_ms.qa").read
