"""One run of one cell: set-up, the measured window, the check by the
reference, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import torch

from bench_h100.harness import check, serve, spec, weights
from bench_h100.harness.trace import WINDOW, Trace
from bench_h100.reference.frontend.text import TextFrontend
from bench_h100.traffic import generator

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "toucan_tpu"}


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: dict
    config: dict
    mix: dict
    records: list          # every sentence requested in the window
    window_s: float        # host clock, window start to the end of its last request
    setup_s: float
    trace: Trace = None
    frontend_s: list = dataclasses.field(default_factory=list)
    sentence_latency: bool = True   # a record's send-to-done is its sentence's own wait

    @property
    def served(self) -> list:
        return [r for r in self.records if "frames" in r]


def percentile_ms(run: Run, q: float):
    """The ``q``-th percentile (inclusive method of ``statistics.quantiles``)
    of every request's send-to-done time; a failed request counts as the
    slowest."""
    if not run.records or not run.sentence_latency:
        return None
    lat = sorted(r["t_done"] - r["t_send"] if "frames" in r else float("inf") for r in run.records)
    pos = (len(lat) - 1) * q / 100.0
    lo, hi = int(pos), min(int(pos) + 1, len(lat) - 1)
    return 1e3 * (lat[lo] + (lat[hi] - lat[lo]) * (pos - lo))


def since_process_start() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card(device) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(torch.device(device).index or 0)],
                             capture_output=True, text=True, timeout=20)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


@dataclasses.dataclass
class Setup:
    """A cell's data and the reference's modules, made from the seed."""
    name: str
    cell: dict
    config: dict
    mix: dict
    limits: dict
    schedule: list
    tts: torch.nn.Module
    voc: torch.nn.Module
    embedding: object
    seed: int = 0
    family: object = None       # the configuration's module in families/
    features: dict = dataclasses.field(default_factory=dict)   # sentence -> reference features


def prepare(cell_name: str, seed: int, device, config_override=None, mix_override=None,
            parts=None) -> Setup:
    """The schedule (sentences and phone counts, from the seed) and the
    reference's modules on ``device`` by the weights recipe.  ``parts``
    collects the seconds of each step."""
    parts = {} if parts is None else parts
    t0 = time.perf_counter()
    cell = spec.cell(cell_name)
    config = config_override or spec.config(cell["config"])
    mix = mix_override or generator.load_mix(cell["traffic"])
    frontend = TextFrontend(language="en", use_g2p=True)
    features = {}

    def count(text):
        if text not in features:
            features[text] = frontend.string_to_features(text)
        return len(features[text])

    schedule = generator.sentences(mix, seed, count)
    features = {t: features[t] for t, _ in schedule}
    calibration = [(features[t], len(t.split())) for t, _ in schedule[:2 * mix["block"]]]
    parts["traffic_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tts, voc, emb = weights.make(config, seed, device, calibration, check.LANG_EN,
                                 generator.frames_per_word(mix["corpus"]))
    parts["weights_s"] = time.perf_counter() - t0
    return Setup(cell_name, cell, config, mix, spec.limits(cell_name), schedule, tts, voc, emb,
                 seed, spec.family(config), features)


def execute(cell_name: str, seed: int, seconds: float, traced: bool, device="cuda",
            config_override=None, mix_override=None, on_interface=None) -> tuple:
    """Run the cell; returns the result line's object and what else the run
    saw (set-up parts, near-ties, frames a phone).  The overrides and
    ``on_interface`` (a function of the built interface) are for the CPU
    tests; a benchmark run passes none."""
    parts = {"imports_s": since_process_start()}
    st = prepare(cell_name, seed, device, config_override, mix_override, parts)
    cell, config, mix, limits, schedule = st.cell, st.config, st.mix, st.limits, st.schedule
    tts, voc, emb = st.tts, st.voc, st.embedding
    t0 = time.perf_counter()
    iface = st.family.build_interface(config, tts.state_dict(), voc.state_dict(), emb, seed,
                                      device)
    tts.to("cpu"), voc.to("cpu")
    parts["interface_s"] = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if on_interface is not None:
        on_interface(iface)
    trace = Trace() if traced else None
    sample = check.Sample(seed)
    client = spec.client(mix["client"])(st, sample, iface, span=Trace.span if traced else None)
    t0 = time.perf_counter()
    client.precompile()
    parts["precompile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    client.warm()
    parts["warm_s"] = time.perf_counter() - t0
    frontend_s = []
    if traced:
        _wrap_frontend(iface.text2phone, frontend_s)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = since_process_start()
    buckets = len(iface._e2e_cache)
    if traced:
        with trace.record():
            with Trace.span(WINDOW):
                window_s = client.run(seconds)
    else:
        window_s = client.run(seconds)
    closed = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    captures = len(iface._e2e_cache) - buckets   # made on a live request
    client.finish()
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"the JAX stack is loaded: {', '.join(loaded)}")
    if traced:
        del iface.text2phone.string_to_features

    run = Run(cell, config, mix, client.records, window_s, setup_s, trace, frontend_s,
              client.sentence_latency)
    picks = sample.picks(client.records)
    program_features = {i: iface.text2phone.string_to_features(
        schedule[client.records[i]["item"]][0]) for i in picks}
    noise_shapes = client.draws
    client.iface = iface = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    tts.to(device), voc.to(device)
    if cuda:
        check.set_tf32(False)
    t0 = time.perf_counter()
    numbers, ties = check.judge(st.family.Reference(tts, voc, emb, device), client.records,
                                picks, schedule, program_features, seed, noise_shapes,
                                client.given)
    check_s = time.perf_counter() - t0
    failed = len(run.records) - len(run.served)
    correct = (failed == 0 and bool(picks)
               and all(numbers[k] <= limits[k] for k in numbers))

    metrics = {}
    t0 = time.perf_counter()
    for name, unit, read in spec.metrics(cell_name, traced):
        value = read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = card(device) if cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = peak
    out = {"correct": correct, "attempted": len(run.records), "failed": failed,
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.top_gaps()}
    readers_s = time.perf_counter() - t0
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    info = {"window_s": window_s, "captures_in_window": captures, "check_s": check_s,
            "judged": len(picks), "near_ties": ties, "frames_per_phone": _frames_per_phone(run),
            "phones_per_sentence": _mean(r["phones"] for r in run.served),
            "seconds_per_sentence": _mean(r["frames"] * serve.SAMPLES_PER_FRAME
                                          / serve.SAMPLE_RATE for r in run.served),
            "setup_parts": parts, "readers_s": readers_s,
            "after_window_s": time.perf_counter() - closed}
    if traced:
        info["trace_parts"] = trace.parts
    return out, info


def _mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def _frames_per_phone(run: Run):
    phones = sum(r["phones"] for r in run.served)
    return sum(r["frames"] for r in run.served) / phones if phones else None


def _wrap_frontend(frontend, times: list):
    """Time every ``string_to_features`` of the interface's frontend in a
    ``bench.frontend`` span (the traced run only)."""
    inner = frontend.string_to_features

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        with Trace.span("bench.frontend"):
            out = inner(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    frontend.string_to_features = timed


def report(out: dict, info: dict):
    """What the run saw besides its metrics (``info``) and the checks as
    the last lines on standard error, and the result as the last line on
    standard output."""
    print("info " + json.dumps(info), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
