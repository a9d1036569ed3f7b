"""Where the CPU suite's time goes: a pytest plugin, measurement only.

For each test it writes one JSON line: its wall seconds, the seconds
JAX spent tracing, lowering and compiling the reference's programs in
it (``jax.monitoring``'s duration events), the persistent-cache reads,
and the CPU seconds of the worker's main thread and of its other
threads (XLA's compile and Eigen pools among them, from
``/proc/self/task``), and the worker's peak resident size so far.  It
changes no result.  Run the tier-1 line with
it loaded and a HOME of its own, so that the compile cache starts
empty, then sum the lines::

    HOME=$(mktemp -d) PYTHONPATH=tests SUITE_METER=/tmp/meter.jsonl \\
        PYTEST_ADDOPTS="-p _suite_meter --durations=0" <the tier-1 line>
    python tests/_suite_meter.py /tmp/meter.jsonl
"""

import collections
import json
import os
import resource
import sys
import time

import pytest

_EVENTS = {"/jax/core/compile/backend_compile_duration": "compile",
           "/jax/core/compile/jaxpr_trace_duration": "trace",
           "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower",
           "/jax/compilation_cache/cache_retrieval_time_sec": "read"}
_acc = collections.Counter()
_TICK = os.sysconf("SC_CLK_TCK")


def _listener(event, duration, **_):
    if event in _EVENTS:
        _acc[_EVENTS[event]] += duration


def _thread_cpu():
    """(main thread, other threads) CPU seconds of this process."""
    main = other = 0
    for t in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{t}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:             # the thread ended meanwhile
            continue
        ticks = int(fields[11]) + int(fields[12])
        if t == str(os.getpid()):
            main += ticks
        else:
            other += ticks
    return main / _TICK, other / _TICK


def pytest_configure(config):
    import jax.monitoring
    jax.monitoring.register_event_duration_secs_listener(_listener)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    before, cpu0, t0 = dict(_acc), _thread_cpu(), time.perf_counter()
    yield
    wall, cpu1 = time.perf_counter() - t0, _thread_cpu()
    row = {"test": item.nodeid, "wall": round(wall, 3),
           "cpu_main": round(cpu1[0] - cpu0[0], 2),
           "cpu_other": round(cpu1[1] - cpu0[1], 2),
           "peak_rss_mib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss // 1024}
    row.update({k: round(_acc[k] - before.get(k, 0.0), 3)
                for k in _EVENTS.values()})
    with open(os.environ.get("SUITE_METER", "suite_meter.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")


def summarize(path):
    """Sum the lines by test file and by the reference's files against
    the port's (``test_torch_*``)."""
    keys = ("wall", "compile", "trace", "lower", "read", "cpu_main",
            "cpu_other")
    by_file = collections.defaultdict(collections.Counter)
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            name = row["test"].split("::")[0]
            side = "port" if "test_torch_" in name else "reference"
            for k in keys:
                by_file[name][k] += row[k]
                by_file[side][k] += row[k]
            by_file[name]["n"] += 1
            by_file["peak"]["rss"] = max(by_file["peak"]["rss"],
                                         row.get("peak_rss_mib", 0))
    peak = by_file.pop("peak")["rss"]
    print(f"largest worker's peak resident size: {peak} MiB")
    print("seconds summed over the workers: " + " ".join(keys))
    for name, c in sorted(by_file.items(), key=lambda kv: -kv[1]["wall"]):
        print(f"{name:60s} " + " ".join(f"{c[k]:8.1f}" for k in keys)
              + (f" {c['n']:4d} tests" if c["n"] else ""))


if __name__ == "__main__":
    summarize(sys.argv[1])
