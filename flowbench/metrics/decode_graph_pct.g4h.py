"""``decode_graph_pct.qa``'s reading in granite-4.0-h-small's cell: the share
of the window's decode steps (pages and state slots) served by replaying a
bucket's CUDA graph."""
import pathlib

from flowbench.harness import load_module

read = load_module(pathlib.Path(__file__).with_name("decode_graph_pct.qa.py"),
                   "flowbench_metric_decode_graph_pct.qa").read
