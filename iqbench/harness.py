"""One run of one cell: find its pieces by name, set up, measure a closed
loop for the window, check the answers against the plain reference, and
build the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``),
whose ``driver`` names the module in ``drivers/`` that runs it.  A driver
is a class ``Driver(ctx)`` whose constructor is the set-up (model, weights
and inputs from the seed) and which has ``units`` (what its end-to-end rate
counts, matched to the metric whose unit is ``<units>/s``), ``warmup()``,
``step()`` (one call into the port; returns the units it completed),
``finish()`` (wait for the device), ``release()`` (free the port's state),
``samples()``, ``reference(sample, tf32)`` and ``compare(program,
reference)`` (the check) and ``work()`` (the counts the per-layer readers
turn into operations).  A per-layer metric is ``metrics/<name>.py`` with
``read(ctx) -> float or None``.  The limits of a cell's check are
``limits/<cell>.json``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "interpret_quality_tpu"}


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with every piece it names, found by name."""

    def __init__(self, name: str, root: str = ROOT):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(cells)}")
        self.name, self.spec, self.bench = name, cells[name], bench
        pkg = os.path.join(root, "iqbench")
        self.cfg = load_json(os.path.join(pkg, "configs",
                                          self.spec["config"] + ".json"))
        self.traffic = load_json(os.path.join(pkg, "traffic",
                                              self.spec["traffic"] + ".json"))
        self.limits = load_json(os.path.join(pkg, "limits", name + ".json"))
        self.driver_path = os.path.join(pkg, "drivers",
                                        self.traffic["driver"] + ".py")
        self.metric_dir = os.path.join(pkg, "metrics")

    def _applies(self, metric) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self._applies(m)]

    def driver_class(self):
        return load_module(self.driver_path,
                           "iqbench_driver_" + self.traffic["driver"]).Driver

    def reader(self, metric: str):
        return load_module(os.path.join(self.metric_dir, metric + ".py"),
                           "iqbench_metric_" + metric.replace(".", "_")).read


def prepare_environment(cfg, root: str = ROOT) -> None:
    """Caches inside the checkout at fixed paths, the configuration's
    precision settings, and no JAX behind any library.  Before the port is
    imported."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for key in ("IQTPU_KNN_SELECT", "IQTPU_KNN_LAYOUT", "IQTPU_ENUM_PLAN"):
        os.environ[key] = str(cfg["precision"][key])


def set_port_precision(cfg) -> None:
    """The configuration's product and gather settings in the port."""
    from interpret_quality_tpu_torch import config as port_config
    from interpret_quality_tpu_torch.ops.precision import set_matmul_precision
    p = cfg["precision"]
    set_matmul_precision(p["matmul_precision"])
    port_config.set_gather_value_parts({"hilo": 2, "bf16": 1}[p["gather_precision"]])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Context:
    """What a driver is given: the cell's pieces, the seed, the device and
    the span wrapper; after the window, what a per-layer reader reads."""

    def __init__(self, cell: Cell, seed: int, device, overrides=None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = dict(cell.cfg, **(overrides or {}).get("config", {}))
        self.traffic = dict(cell.traffic, **(overrides or {}).get("traffic", {}))
        self.window_s = self.units = self.trace = self.peaks = None
        self.driver = None
        self._work = None

    @staticmethod
    def span(name: str, fn: Callable) -> Callable:
        """fn inside a profiler span ``name``, in every run alike."""
        from torch.profiler import record_function

        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    def work(self):
        if self._work is None:
            self._work = self.driver.work()
        return self._work


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(ctx: Context, driver, seconds: float, trace: bool):
    """The closed loop: calls back to back until ``seconds`` have passed,
    then wait for the device.  Returns (units, calls, window seconds)."""
    from torch.profiler import record_function
    prof = None
    if trace:
        from . import trace as trace_mod
        prof = trace_mod.start(ctx.device)
    units = calls = 0
    with record_function("iqbench.window"):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            units += driver.step()
            calls += 1
            if time.perf_counter() >= deadline:
                break
        driver.finish()
        window = time.perf_counter() - t0
    if prof is not None:
        from . import trace as trace_mod
        ctx.trace = trace_mod.summarize(prof)
        print(f"trace: {len(ctx.trace.kernels)} device operations, "
              f"{ctx.trace.attributed:.4f} with their launch", file=sys.stderr)
    return units, calls, window


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             start: float, device: str = "cuda", root: str = ROOT,
             overrides: Optional[dict] = None) -> Dict:
    """One run of a cell; ``start`` is the process's start on the
    ``time.monotonic`` clock.  Returns the result line as a dict."""
    cell = Cell(workload, root)
    prepare_environment(cell.cfg, root)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < cell.spec["chips"]:
            raise SystemExit(f"the cell needs {cell.spec['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
    set_port_precision(cell.cfg)
    ctx = Context(cell, seed, torch.device(device), overrides)
    t_import = time.monotonic()
    driver = ctx.driver = cell.driver_class()(ctx)
    t_driver = time.monotonic()
    driver.warmup()
    synchronize(device)
    setup_s = time.monotonic() - start
    print(f"setup: {t_import - start:.3f} s to the port's import, "
          f"{t_driver - t_import:.3f} s the driver's set-up, "
          f"{start + setup_s - t_driver:.3f} s the warm-up", file=sys.stderr)

    units, calls, window = measure(ctx, driver, seconds, trace)
    ctx.window_s, ctx.units = window, units
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell.spec["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if device == "cuda" else 0)}

    metrics = {}
    if trace:
        ctx.peaks = load_json(os.path.join(PKG, "peaks.json")).get(dev["kind"])
        dev["busy_s"], dev["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
        for m in cell.per_layer():
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] == "setup_s":
                value = setup_s
            elif m["unit"] == driver.units + "/s":
                value = units / window
            else:
                raise SystemExit(f"no reading for end-to-end metric {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the work counts read the port's inputs only; then the port's state goes
    if trace:
        ctx.work()
    driver.release()
    if device == "cuda":
        torch.cuda.empty_cache()

    numbers = check(driver, cell.limits)
    correct = all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in numbers.values())
    # last, so that what the readers, the counts and the check load counts too
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    result = {"correct": correct, "attempted": calls, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = ctx.trace.breakdown()
    result["check"] = numbers
    return result


def check(driver, limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number the check compares (those ``limits`` names), the worst
    over the sampled answers, beside its limit; a reading that is not
    finite is given as None, and fails."""
    worst = readings(driver, lambda s: s["program"], limits)
    return {name: {"value": worst[name] if math.isfinite(worst[name]) else None,
                   "limit": limits[name]}
            for name in sorted(limits)}


def readings(driver, program, names=None) -> Dict[str, float]:
    """The worst reading of every number ``compare`` gives (or of those in
    ``names``) over the driver's samples, with ``program(sample)`` in the
    program's place."""
    worst: Dict[str, float] = {}
    for sample in driver.samples():
        want = driver.reference(sample, False)
        got = driver.compare(program(sample), want)
        for name, value in got.items():
            if names is None or name in names:
                value = float(value)
                if not math.isfinite(value):        # max() would drop a NaN
                    value = math.inf
                worst[name] = max(worst.get(name, 0.0), value)
    missing = set(names or ()) - set(worst)
    if missing:
        raise SystemExit(f"the check does not compare {sorted(missing)}")
    return worst


def control_readings(driver) -> Dict[str, float]:
    """The control: the reference at the nearest precision below the
    configuration's (TF32 for float32 with TF32 off) in the program's
    place."""
    return readings(driver, lambda s: driver.reference(s, True))
