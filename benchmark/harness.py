"""One run of one cell: set-up, the measured window, the check, the line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
traffic file names its driver (``drivers/<driver>.py``), which sets the
program up, drives the window and checks what the window produced against
``reference/``.  The run prints each number compared beside its limit on
standard error, then one JSON line on standard output.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "image_caption_tpu")


def load_json(rel: str) -> Dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload resolved to its files."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    spec: Dict


def resolve(workload: str, traffic: Optional[str] = None) -> Cell:
    """``workload`` of ``BENCHMARK.json``, its configuration file and its
    traffic file (``traffic`` replaces the cell's, for sweeps)."""
    spec = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(configs[w["config"]]["file"])
    mix = load_json(os.path.join("benchmark", "traffic",
                                 (traffic or w["traffic"]) + ".json"))
    return Cell(workload, w["chips"], config, mix, spec)


@dataclass
class Window:
    """What a driver's window did: units of work (steps, batches) and
    items (images) completed, over ``seconds`` of the host clock."""
    units: int = 0
    items: int = 0
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    flops_per_unit: Dict[str, float] = field(default_factory=dict)
    kernel4: Optional[Tuple[int, str]] = None     # crops a batch, dtype

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


@dataclass
class Run:
    """What a per-layer metric reads."""
    cell: Cell
    window: Window
    trace: object


class Context:
    """A run's arguments, cell and device, and its seeds: ``seed(tag)``
    gives a sub-seed for each use of the run's seed.  ``tracer`` is set in
    a traced run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device: str,
                 workdir: str):
        self.cell, self.base_seed, self.seconds = cell, seed, seconds
        self.device, self.workdir = device, workdir
        self.tracer = None

    def seed(self, tag: int) -> int:
        from .reference.captioner import fold_in
        return fold_in(self.base_seed, tag)

    def sync(self) -> None:
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def metric_reader(name: str) -> Callable:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: Dict, cell: Cell, e2e_of_cell: List[str]) -> bool:
    """A per-layer metric is read in the cells it lists, else in every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell.name in metric["workloads"]
    return metric["moves"] in e2e_of_cell


class tf32:
    """TF32 for matmuls and cuDNN set to ``on`` inside the block: off for
    the reference, on for a TF32 control."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.was


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None,
            control: Optional[str] = None) -> Dict:
    """Run ``cell`` and return its result line (a dict).  ``device`` "cpu"
    serves the tests; ``control`` (the driver's name of a control or a
    planted fault) serves ``limits.py``: the check then judges that in
    the program's place."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    drv = driver(cell)
    with tempfile.TemporaryDirectory(prefix="bench_") as workdir:
        ctx = Context(cell, seed, seconds, device, workdir)
        state = drv.setup(ctx)
        if trace:
            from .trace import Tracer
            ctx.tracer = Tracer(cell.traffic["trace_units"], workdir)
        ctx.sync()
        setup_s = time.perf_counter() - t_start
        win = drv.window(ctx, state)
        ctx.sync()
        # a driver whose set-up ends inside its window's call says when
        setup_s = getattr(state, "opened", setup_s + t_start) - t_start
        tr = ctx.tracer.close() if trace else None
        peak = (max(torch.cuda.max_memory_allocated(i)
                    for i in range(cell.chips)) if device != "cpu" else 0)
        drv.free(state)
        with tf32(False):
            checks = (drv.check(ctx, state, control) if control
                      else drv.check(ctx, state))
    correct = all(v <= lim for v, lim in checks.values())
    spec = cell.spec
    e2e = [m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell.name in m["workloads"]]
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                metrics[m["name"]] = {"value": setup_s, "unit": "s"}
            elif m["name"] in e2e and m["name"] == cell.traffic["metric"]:
                metrics[m["name"]] = {"value": win.items / win.seconds,
                                      "unit": m["unit"]}
    else:
        run = Run(cell, win, tr)
        for m in spec["per_layer"]:
            if applies(m, cell, e2e):
                value = metric_reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": win.attempted,
            "failed": win.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                             "idle_gaps": [list(x) for x in tr.idle_gaps]}
    # JSON has no infinity: a number without bound prints as 1e300
    line["checks"] = {k: {"value": min(v, 1e300), "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(args, t_start: float) -> int:
    import torch
    cell = resolve(args.workload, args.traffic)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = execute(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
