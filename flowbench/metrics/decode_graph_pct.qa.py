"""Share of the window's ``decode_step`` spans before the profiler whose
``graph`` attr is ``"replay"``: the decode steps the engine served by
replaying its bucket's CUDA graph (``"capture"`` and ``"eager"`` steps
count against it). None where no span carries the attr (a program
without the graphs)."""
from typing import Optional

from flowbench.phases import decode_steps


def read(run) -> Optional[float]:
    hows = [s.attrs["graph"] for s in decode_steps(run) if "graph" in s.attrs]
    if not hows:
        return None
    return 100.0 * hows.count("replay") / len(hows)
