"""One run of one cell: set up the port's 1P+1D cluster, drive it with the
cell's traffic through ``FlowKVClient.submit`` / ``step``, time what a
client sees, read the per-layer metrics in a traced run, and judge the
served tokens against the plain reference.

Everything a cell needs is found by name, so that a cell, a configuration,
a mix or a metric is added as files alone:

* ``BENCHMARK.json``'s entry names the cell's configuration and its mix;
* ``configs/<config>.json``: the sizes as run (``port_config`` reads them,
  a ``port`` object for any family the port builds; ``flops.py`` counts the
  published keys, and ``port_config`` refuses a file whose two disagree)
  and ``reference``, which names ``reference/<reference>.py``;
* ``traffic/<mix>.json``: the generator's parameters (``traffic.py``);
* ``cells/<workload>.json``: the load (``rate`` or ``clients``),
  ``num_blocks`` and ``max_batch_tokens`` a node, ``warmup``,
  ``trace_slice_s`` and ``check`` (the correctness limits, ``check.py``);
* ``metrics/<metric>.py``: ``read(run) -> float | None``;
* ``families/<family>.py``: ``counted_keys(ModelConfig) -> dict``, for a
  family of the port that ``counted_keys`` here does not know.

A reference module has to offer two functions, and the harness and
``check.py`` use nothing else of it:

* ``make_weights(cfg, seed, device) -> params``: the weights from the seed
  on the device, in the port's layout and served type; the program gets
  these same tensors;
* ``logits_at(params, cfg, tokens, rows, quant=None) -> Tensor``: float32
  logits ``(len(rows), vocab)`` of the sequence ``tokens`` at ``rows``;
  ``quant="fp8"`` is the control, the same forward a precision step below.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from flowbench import check, traffic


FAMILIES = pathlib.Path(__file__).resolve().parent / "families"


class NoDevice(RuntimeError):
    """The cell asks for cards this machine does not have."""


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    root: pathlib.Path
    name: str
    entry: Dict
    cfg: Dict
    mix: Dict
    load: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def reference(self):
        return load_module(self.root / "reference" / f"{self.cfg['reference']}.py",
                           f"flowbench_reference_{self.cfg['reference']}")

    def reader(self, metric: str) -> Callable:
        return load_module(self.root / "metrics" / f"{metric}.py",
                           f"flowbench_metric_{metric}").read


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, bench_root: pathlib.Path) -> Cell:
    """The cell ``workload`` of ``bench_root/BENCHMARK.json`` and its files;
    ``bench_root`` holds the benchmark's folder as ``paths[0]``."""
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    root = bench_root / bench["paths"][0]
    return Cell(
        root=root, name=workload, entry=entry,
        cfg=json.loads((bench_root / configs[entry["config"]]["file"]).read_text()),
        mix=json.loads((root / "traffic" / f"{entry['traffic']}.json").read_text()),
        load=json.loads((root / "cells" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def port_config(cfg: Dict):
    """The configuration file as the port's ``ModelConfig``.

    A file with a ``port`` object builds ``ModelConfig(name=<name>,
    family=<family>, **port)``: ``family`` is any family
    ``models.api.get_model`` builds, each key of ``port`` is a field of
    ``ModelConfig`` (an unknown one is an error), ``dtype`` is the name of a
    torch type and a tuple is a list. A file without one is a dense or top-k
    MoE decoder read from its published keys (``ffn`` says which).

    A file that ``flops.py`` can count (it has ``ffn``) describes the model
    twice, so the published keys that ``flops.py`` reads have to be what the
    port builds (``counted_keys``): a file whose two disagree is refused."""
    out = _build_port_config(cfg)
    if "ffn" in cfg:
        built, counted = counted_keys(out), _counted_keys_of_file(cfg)
        differ = {k: (counted.get(k), v) for k, v in built.items() if counted.get(k) != v}
        if differ:
            raise ValueError(f"{cfg['name']}: flops.py would count another model than the "
                             f"port builds; key: (file, built) {differ}")
    return out


def counted_keys(mc) -> Dict:
    """The published keys that ``flops.py`` reads, as they describe the
    model the port builds from the ``ModelConfig`` ``mc``. A family other
    than dense, MoE and Mamba-2 is described by ``families/<family>.py``'s
    ``counted_keys(mc)``; without one, and for windowed attention, this
    raises: the port builds a layer that ``flops.py`` has no count for."""
    own = FAMILIES / f"{mc.family}.py"
    if mc.family not in ("dense", "moe", "ssm") and own.exists():
        return load_module(own, f"flowbench_family_{mc.family}").counted_keys(mc)
    if mc.family in ("dense", "moe") and not mc.attn_window:
        out = {"layer_types": ["attention"] * mc.num_layers,
               "num_attention_heads": mc.num_heads,
               "num_key_value_heads": mc.num_kv_heads, "head_dim": mc.head_dim}
    elif mc.family == "ssm":
        # models/mamba2.py: Mamba-2 mixers with one group of B and C, no FFN
        out = {"layer_types": ["mamba"] * mc.num_layers, "mamba_n_heads": mc.ssm_heads,
               "mamba_d_head": mc.ssm_head_dim, "mamba_d_state": mc.ssm_state,
               "mamba_n_groups": 1, "mamba_d_conv": mc.ssm_conv,
               "mamba_chunk_size": mc.ssm_chunk}
    else:
        what = "windowed attention" if mc.attn_window else f"the {mc.family!r} family"
        raise ValueError(f"{mc.name}: flops.py has no count for {what} as the port "
                         f"builds it")
    if mc.family == "moe":
        out.update(ffn="moe_topk", intermediate_size=mc.moe_d_ff,
                   num_local_experts=mc.num_experts, num_experts_per_tok=mc.top_k)
    elif mc.family == "dense":
        out.update(ffn="gated_mlp", intermediate_size=mc.d_ff)
    else:
        out.update(ffn="none")
    out.update(hidden_size=mc.d_model, num_hidden_layers=mc.num_layers,
               vocab_size=mc.vocab_size, shared_intermediate_size=0,
               dtype=str(mc.dtype).removeprefix("torch."))
    return out


def _counted_keys_of_file(cfg: Dict) -> Dict:
    """The keys ``counted_keys`` names, as ``flops.py`` reads them from the
    file: its defaults filled in."""
    from flowbench import flops

    out = dict(cfg, layer_types=flops.layer_kinds(cfg),
               shared_intermediate_size=cfg.get("shared_intermediate_size", 0),
               mamba_n_groups=cfg.get("mamba_n_groups", 1))
    if "num_attention_heads" in cfg:
        out["head_dim"] = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    return out


def _build_port_config(cfg: Dict):
    import torch
    from repro_torch.models.api import get_model
    from repro_torch.models.common import ModelConfig

    if "port" in cfg:
        kw = dict(cfg["port"])
        fields = {f.name for f in dataclasses.fields(ModelConfig)} - {"name", "family"}
        unknown = sorted(set(kw) - fields)
        if unknown:
            raise ValueError(f"{cfg['name']}: port keys {unknown} are not fields of "
                             f"ModelConfig (name and family sit beside port)")
        if "dtype" in kw:
            kw["dtype"] = getattr(torch, kw["dtype"])
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
        out = ModelConfig(name=cfg["name"], family=cfg["family"], **kw)
        get_model(out)                      # an unknown family raises here
        return out
    moe = cfg["ffn"] == "moe_topk"
    if cfg.get("family", "moe" if moe else "dense") != ("moe" if moe else "dense"):
        raise ValueError(f"{cfg['name']}: family {cfg['family']!r} needs a port object")
    kw = dict(num_experts=cfg["num_local_experts"], top_k=cfg["num_experts_per_tok"],
              moe_d_ff=cfg["intermediate_size"], d_ff=0) if moe else \
        dict(d_ff=cfg["intermediate_size"])
    return ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        vocab_size=cfg["vocab_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
        qk_norm=bool(cfg.get("qk_norm")), rope_theta=float(cfg["rope_theta"]),
        dtype=getattr(torch, cfg["dtype"]), block_size=cfg["block_size"],
        tie_embeddings=cfg.get("tie_word_embeddings", True),
        norm_eps=cfg["rms_norm_eps"], flash_threshold=cfg["flash_threshold"], **kw)


# ---------------------------------------------------------------------------
# What the run observed
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Step:
    t0: float                       # host clock around one client.step()
    t1: float
    decode_contexts: List[int]      # cached tokens each decode token attended


class HostTimeline:
    """Non-overlapping host intervals ``(label, start_ns, end_ns)`` labelled
    by the innermost wrapped call (traced runs only)."""

    def __init__(self):
        self.segments: List[tuple] = []
        self._stack: List[list] = []

    def wrap(self, obj, attr: str, label: str) -> None:
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            now = time.time_ns()
            if self._stack:
                outer = self._stack[-1]
                self.segments.append((outer[0], outer[1], now))
            self._stack.append([label, now])
            try:
                return fn(*a, **kw)
            finally:
                end = time.time_ns()
                lab, start = self._stack.pop()
                self.segments.append((lab, start, end))
                if self._stack:
                    self._stack[-1][1] = end

        setattr(obj, attr, wrapped)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    peak: Optional[Dict]            # the card's published peaks (None on the CPU)
    setup_s: float = 0.0
    t_start: float = 0.0            # window, host monotonic seconds
    t_end: float = 0.0
    reqs: List[traffic.Req] = dataclasses.field(default_factory=list)
    steps: List[Step] = dataclasses.field(default_factory=list)   # window steps
    spans: List = dataclasses.field(default_factory=list)
    late_s: List[float] = dataclasses.field(default_factory=list)
    # traced slice of the window
    slice_mono: Optional[tuple] = None
    slice_ns: Optional[tuple] = None
    traced_from: float = float("inf")   # host clock when the profiler was asked to start
    device_records: List[tuple] = dataclasses.field(default_factory=list)
    host: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def cfg(self) -> Dict:
        return self.cell.cfg

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def window_reqs(self) -> List[traffic.Req]:
        return [r for r in self.reqs if r.in_window]

    def slice_steps(self) -> List[Step]:
        if self.slice_mono is None:
            return []
        lo, hi = self.slice_mono
        return [s for s in self.steps if s.t0 >= lo and s.t1 <= hi]

    def window_trace_ids(self) -> set:
        return {r.rid for r in self.window_reqs()}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------
def _device(chips: int, device):
    import torch

    if device is not None:
        return torch.device(device), "cpu", "cpu"
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0), "gpu", torch.cuda.get_device_name(0)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    """Submits requests, steps the client, stamps every token as the client
    sees it: on the host clock right after the ``step()`` that made it."""

    def __init__(self, client, run: Run, sampling_cls):
        self.client, self.run, self.sampling_cls = client, run, sampling_cls
        self.active: List[traffic.Req] = []

    def submit(self, r: traffic.Req) -> None:
        r.handle = self.client.submit(r.prompt, self.sampling_cls(max_new_tokens=r.max_new))
        r.rid = r.handle.request_id
        self.active.append(r)
        self.run.reqs.append(r)

    def step(self) -> tuple:
        t0 = time.monotonic()
        self.client.step()
        t1 = time.monotonic()
        contexts, finished = [], []
        for r in self.active:
            out = r.handle.request.output_tokens
            n, seen = len(out), len(r.token_t)
            if n > seen:
                r.token_t.extend([t1] * (n - seen))
                # token j > 0 came from a decode step over prompt + j - 1 cached
                contexts.extend(r.prompt_len + j - 1 for j in range(max(seen, 1), n))
                if r.first_t is None:
                    r.first_t = t1
            if r.handle.done:
                finished.append(r)
        if finished:
            self.active = [r for r in self.active if not r.handle.done]
        return Step(t0, t1, contexts), finished


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            bench_root: pathlib.Path, t_process: float, device=None,
            plant: Optional[Callable] = None, control: bool = False,
            load: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, maybe ``breakdown``, then
    ``checks``) plus ``log`` lines for standard error and a ``summary``.

    ``plant`` (tests) gets the client before any traffic; ``control`` also
    judges the control in the program's place (``control``: its
    ``correct`` and ``checks``); ``load`` overrides fields of the cell's load
    (the knee's sweep). The benchmark's runs use none of them."""
    import torch

    cell = load_cell(workload, bench_root)
    if load:
        cell.load = dict(cell.load, **load)
    dev, platform, kind = _device(cell.chips, device)
    from repro_torch.serving.api import FlowKVClient
    from repro_torch.serving.request import SamplingParams
    from flowbench import flops

    log: List[str] = []
    pcfg = port_config(cell.cfg)
    ref = cell.reference()
    params = ref.make_weights(cell.cfg, seed, dev)
    client = FlowKVClient(pcfg, params, num_prefill=1, num_decode=1,
                          num_blocks=cell.load["num_blocks"],
                          max_batch_tokens=cell.load.get("max_batch_tokens", 2048),
                          device=dev)
    if plant is not None:
        plant(client)
    preempted = _count_preemptions(client)
    run = Run(cell=cell, peak=flops.peaks(kind) if platform == "gpu" else None)
    drv = Driver(client, run, SamplingParams)
    vocab = cell.cfg["vocab_size"]
    prof = None
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):       # CUPTI's start-up
            torch.zeros(1, device=dev).add_(1)
            _sync(dev)
        prof = profile(activities=[ProfilerActivity.CUDA])

    _warm_up(drv, cell, seed)
    open_loop = cell.mix["loop"] == "open"
    if open_loop:
        gen = traffic.OpenLoop(cell.mix, cell.load, seed, seconds, vocab)
        base = time.monotonic() + float(cell.mix.get("preroll_s", 0.0))
        pending = list(gen.preroll)
        while pending or time.monotonic() < base:
            now = time.monotonic()
            while pending and base + pending[0].due <= now:
                r = pending.pop(0)
                r.due_at = base + r.due
                drv.submit(r)
            if drv.active:
                drv.step()
            else:
                time.sleep(0.001)
    else:
        gen = traffic.ClosedLoop(cell.mix, cell.load, seed, vocab)
        now = time.monotonic()
        for c in range(gen.clients):
            r = gen.next_request(c, first=True)
            r.due_at = now
            drv.submit(r)
        # the fill: every client's first prompt prefilled, then some cycles
        fill = True
        cycles = int(cell.mix.get("preroll_cycles", 0))
        while fill or cycles > 0:
            st, done = drv.step()
            for r in done:
                nxt = gen.next_request(r.client, first=False)
                nxt.due_at = st.t1
                drv.submit(nxt)
            if fill:
                fill = any(r.first_t is None for r in drv.active)
            else:
                cycles -= 1

    # -- the window ---------------------------------------------------------
    tracer, timeline = _instrument(client) if trace else (None, None)
    _sync(dev)
    t_start = time.monotonic()
    run.setup_s = t_start - t_process
    run.t_start = run.t_end = t_start
    t_close = t_start + seconds
    span = min(seconds / 2, float(cell.load.get("trace_slice_s", 10.0)))
    run.traced_from = t_close
    pending = list(gen.window) if open_loop else []
    engines = list(client.cluster.engines.values())
    pools = [eng.scheduler.bm for eng in engines]
    pool_peak = [0] * len(pools)
    preempted_before, rejected_before = preempted[0], len(client.cluster.rejected)
    computed = sum(eng.prefill_tokens_computed for eng in engines)
    chunk_steps = 0
    captures_before = sum(eng.decode_graph_captures for eng in engines)
    while True:
        now = time.monotonic()
        if now >= t_close:
            break
        if prof is not None and run.slice_mono is None and now >= t_close - span:
            # the slice: the window's last `span` seconds, from after the
            # profiler's start to before its stop, each behind a synchronise
            _sync(dev)
            run.traced_from = time.monotonic()
            prof.start()
            _sync(dev)
            run.slice_mono, run.slice_ns = (time.monotonic(),), (time.time_ns(),)
        while pending and t_start + pending[0].due <= now:
            r = pending.pop(0)
            r.due_at = t_start + r.due
            drv.submit(r)
            run.late_s.append(now - r.due_at)
        if not drv.active:
            time.sleep(0.001)
            continue
        st, done = drv.step()
        run.steps.append(st)
        run.t_end = st.t1
        held = [bm.num_blocks - bm.num_free - bm.num_cached for bm in pools]
        pool_peak = [max(a, b) for a, b in zip(pool_peak, held)]
        was, computed = computed, sum(eng.prefill_tokens_computed for eng in engines)
        chunk_steps += computed > was
        if not open_loop:
            for r in done:
                nxt = gen.next_request(r.client, first=False)
                nxt.in_window, nxt.due_at = True, st.t1
                drv.submit(nxt)
    if run.slice_mono is not None:
        _sync(dev)
        run.slice_mono = (run.slice_mono[0], time.monotonic())
        run.slice_ns = (run.slice_ns[0], time.time_ns())
        prof.stop()
    backlog = sum(1 for r in run.window_reqs() if r.first_t is None)
    window_preempted = preempted[0] - preempted_before
    window_rejected = len(client.cluster.rejected) - rejected_before
    window_captures = sum(eng.decode_graph_captures for eng in engines) - captures_before
    # -- the drain: every request sent in the window gets its first token ----
    drain_until = time.monotonic() + float(cell.mix.get("drain_s", 0.0))
    while open_loop and any(r.first_t is None for r in run.window_reqs()) \
            and time.monotonic() < drain_until:
        drv.step()
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if trace:
        run.spans = list(tracer.spans)
        run.host = timeline.segments
    if prof is not None and run.slice_mono is not None:
        from flowbench import devtrace
        run.device_records = devtrace.device_records(prof)
        _align(run, log)

    # -- the metrics ------------------------------------------------------------
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        val = cell.reader(m["name"])(run)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    for r in run.reqs:            # the run keeps tokens and states, not the client
        r.output, r.state = list(r.handle.request.output_tokens), r.handle.state.value
        r.handle = None
    wreqs = run.window_reqs()
    attempted = len(wreqs)
    # open loop: a request still without its first token after the drain
    # failed; closed loop: one still in flight at the close is not failed
    failed = sum(1 for r in wreqs
                 if (open_loop and r.first_t is None)
                 or r.state in ("rejected", "cancelled", "failed"))
    device_out = {"platform": platform, "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    result = {"metrics": metrics}
    if run.device_records:
        from flowbench import devtrace
        lo, hi = run.slice_ns
        busy = devtrace.busy_ns(run.device_records, lo, hi) / 1e9
        device_out.update(busy_s=busy, window_s=(hi - lo) / 1e9)
        ops = sorted(devtrace.by_name(run.device_records).items(), key=lambda x: -x[1])
        gaps = sorted(devtrace.idle_gaps(run.device_records, lo, hi, run.host).items(),
                      key=lambda x: -x[1])
        result["breakdown"] = {"device_ops": [[n, s] for n, s in ops[:10]],
                               "idle_gaps": [[n, s] for n, s in gaps[:10]]}
    if run.steps:
        walls = sorted(st.t1 - st.t0 for st in run.steps)
        log.append(f"steps: p50 {walls[len(walls) // 2]:.4f} s, max {walls[-1]:.4f} s; "
                   f"{sum(w > 1.0 for w in walls)} over 1 s; decode batch at most "
                   f"{max(len(st.decode_contexts) for st in run.steps)}")
    if run.late_s:
        lates = sorted(run.late_s)
        log.append(f"generator lateness: p50 {lates[len(lates) // 2]:.6f} s, "
                   f"max {lates[-1]:.6f} s over {len(lates)} sends")
    log.append(f"window {run.window_s:.3f} s, {len(run.steps)} steps, {attempted} "
               f"requests sent, {failed} failed; setup {run.setup_s:.3f} s; "
               f"device {kind}, peak {peak} B")
    log.append("pool blocks held by requests in the window, most at once: " + ", ".join(
        f"node {i} {n} of {bm.num_blocks}" for i, (n, bm) in enumerate(zip(pool_peak, pools))))
    log.append(f"in the window: {chunk_steps} of {len(run.steps)} steps ran a prefill "
               f"chunk; {window_captures} decode graphs captured; {window_preempted} "
               f"decode preemptions, {window_rejected} requests refused")

    # -- correctness: the program's state freed, then the reference ------------
    served = [(r.prompt, r.output, r.max_new) for r in run.reqs
              if r.state == "finished" and r.token_t and r.token_t[-1] >= t_start]
    del drv, client, tracer, timeline, prof, pools, engines
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, ctrl = check.judge(ref, params, cell.cfg, cell.load["check"], served, seed,
                               control=control)
    correct = failed == 0 and check.passed(checks)
    result.update(correct=correct, attempted=attempted, failed=failed,
                  device=device_out)
    if ctrl is not None:
        result["control"] = {"correct": check.passed(ctrl), "checks": ctrl}
    result["checks"] = checks
    result["log"] = log
    result["summary"] = {"backlog_at_close": backlog, "window_s": run.window_s,
                         "steps": len(run.steps), "setup_s": run.setup_s,
                         "late_max_s": max(run.late_s, default=0.0),
                         "pool_blocks_peak": pool_peak, "chunk_steps": chunk_steps,
                         "preempted": window_preempted, "rejected": window_rejected}
    return result


def _count_preemptions(client) -> List[int]:
    """A one-item counter of the decode preemptions (a request swapped out
    under KV pressure) that the client's engines make from now on."""
    count = [0]
    for eng in client.cluster.engines.values():
        def counted(*a, _preempt=eng.scheduler._preempt, **kw):
            count[0] += 1
            return _preempt(*a, **kw)
        eng.scheduler._preempt = counted
    return count


def _warm_up(drv: Driver, cell: Cell, seed: int) -> None:
    """Set-up: run the shapes the cell's traffic will use, so that nothing
    the window meets is loaded for the first time inside it. The cell's
    ``warmup`` names ``prompts`` cold prompts whose lengths step evenly up to
    the prefill budget (the chunk sizes), one prompt of the mix's longest
    length (the attention's longest offsets), and ``decode_batch`` short
    prompts whose outputs end one a step (every decode batch size down from
    it). Their tokens come from the seed, apart from the traffic's."""
    spec = cell.load.get("warmup")
    if not spec:
        return
    budget = int(cell.load.get("max_batch_tokens", 2048))
    n = int(spec["prompts"])
    lens = [max(1, budget * (i + 1) // n - i % 2) for i in range(n)]
    lens.append(int(cell.mix["prompt_len"].get("max", budget)))
    shapes = [(length, 1) for length in lens]
    shapes += [(32, 2 + j) for j in range(int(spec["decode_batch"]))]
    vocab = cell.cfg["vocab_size"]
    for i, (length, out) in enumerate(shapes):
        prompt = np.random.default_rng([seed, 4, i]).integers(0, vocab, length)
        r = traffic.Req(index=-1 - i, prompt=prompt.tolist(), max_new=out)
        drv.submit(r)
    while drv.active:
        drv.step()


def _instrument(client) -> tuple:
    """Traced runs: the program's span recorder attached, and the host's
    time labelled by the layer call it is in (wrapped on the instances)."""
    from repro_torch.obs.tracing import attach_tracer

    tracer = attach_tracer(client.cluster)
    timeline = HostTimeline()
    for eng in client.cluster.engines.values():
        timeline.wrap(eng, "run_prefill", "prefill")
        timeline.wrap(eng, "run_decode", "decode")
        timeline.wrap(eng.scheduler, "schedule", "schedule")
    timeline.wrap(client.cluster, "_transfer", "transfer")
    timeline.wrap(client.cluster, "step", "cluster")
    timeline.wrap(client.cluster.controller, "step", "controller")
    timeline.wrap(client.cluster.controller, "submit_request", "submit")
    return tracer, timeline


def _align(run: Run, log: List[str]) -> None:
    """Kineto stamps device records in Unix-epoch nanoseconds, the clock of
    ``time.time_ns``. Where the first record lies outside the host's slice,
    the clocks differ: the slice and the host timeline are moved onto the
    records' clock, the slice starting at the first record."""
    lo, hi = run.slice_ns
    first = min(s for _, s, _ in run.device_records) if run.device_records else lo
    log.append(f"trace: {len(run.device_records)} device records, the first "
               f"{(first - lo) / 1e9:.6f} s after the host's slice start, slice "
               f"{(hi - lo) / 1e9:.3f} s")
    if lo - 10**9 <= first <= hi:
        return
    shift = first - lo
    run.slice_ns = (lo + shift, hi + shift)
    run.host = [(lab, a + shift, b + shift) for lab, a, b in run.host]
    log.append(f"device clock differs from the host's by {shift} ns: slice moved")
