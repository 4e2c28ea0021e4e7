"""Output tokens a second over the window: every output token of every
request (first tokens too) whose stamp lies inside the window, over the
window's length (its start to the end of its last step)."""


def read(run):
    if run.window_s <= 0:
        return None
    n = sum(1 for r in run.reqs for t in r.token_t if run.t_start < t <= run.t_end)
    return n / run.window_s if n else None
