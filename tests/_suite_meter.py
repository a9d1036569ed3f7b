"""Where the CPU suite's time goes: a pytest plugin, measurement only.

For each test it writes one JSON line: its worker and start time, its
wall seconds, the seconds JAX spent tracing, lowering and compiling the
reference's programs in it (``jax.monitoring``'s duration events), the
programs it met, how many of them were read from the persistent compile
cache rather than compiled and how many took a second or more (the
frame cores; the rest are mostly eager one-op programs), the CPU seconds
of the worker's main thread and of its other threads (XLA's compile and
Eigen pools among them, and threads that ended within the test), the
worker's peak resident size so far, how often ``tests/_jax_maps.py``
cleared JAX's in-memory caches, the process's memory mappings when the
test's body starts and when it ends (``vm.max_map_count`` bounds them),
a digest of each stream the reference's ``Encoder`` was asked for (its
params, and each frame and call given to it), and the keys of the
reference's frame cores it called: the core's name, its static keywords
and its arguments' dtypes and shapes (each core a program of its own per
key).  The cores are wrapped where they live
(``x264_tpu.models.intra_device.i_frame_core`` and the others in
``_CORES``), so a caller that imports them inside a function, as
``x264_tpu/api.py`` does, calls the wrapper.  It changes no result.

Run the tier-1 line with it loaded and a HOME and a TMPDIR of their
own, so that the compile cache starts empty, then sum the lines::

    export HOME=$(mktemp -d) TMPDIR=$(mktemp -d)
    PYTHONPATH=tests SUITE_METER=/tmp/meter.jsonl \\
        PYTEST_ADDOPTS="-p _suite_meter --durations=0" <the tier-1 line>
    python tests/_suite_meter.py /tmp/meter.jsonl

The summary gives each file's seconds and programs, the slowest tests,
each worker's last test and end, and the core keys that the port's
tests (``test_torch_*``) meet and no test of the reference meets.
"""

import collections
import hashlib
import importlib
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
# a backend-compile event is one program met; a retrieval, one read back
_COUNTS = {"compile": "programs", "read": "cache_reads"}
# a program that took this long to compile or read is a frame core's
_BIG_S = 1.0
_TALLIES = tuple(_COUNTS.values()) + ("big_programs", "clears")
_CORES = {"x264_tpu.models.intra_device": ("i_frame_core", "i4_frame_core"),
          "x264_tpu.models.inter_device": ("_p_frame_core_jit",
                                           "p_entropy_core", "p_band_core"),
          "x264_tpu.models.b_frame_device": ("b_frame_core", "b_pair_core"),
          "x264_tpu.ops.device.deblock": ("deblock_frame", "deblock_frame_b",
                                          "deblock_core", "deblock_core_b")}
_acc = collections.Counter()
_keys = set()
_maps = {}
_streams = []
_TICK = os.sysconf("SC_CLK_TCK")


def _listener(event, duration, **_):
    if event in _EVENTS:
        _acc[_EVENTS[event]] += duration
        if _EVENTS[event] in _COUNTS:
            _acc[_COUNTS[_EVENTS[event]]] += 1
        if _EVENTS[event] == "compile" and duration >= _BIG_S:
            _acc["big_programs"] += 1


def _sig(x):
    """dtype and shape of an array, the value of a Python scalar, the
    leaves of a tuple, list or dict."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return repr(x)
    if isinstance(x, (tuple, list)):
        return "(" + ",".join(_sig(v) for v in x) + ")"
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_sig(v)}"
                              for k, v in sorted(x.items())) + "}"
    shape = getattr(x, "shape", None)
    if shape is not None:
        return f"{getattr(x, 'dtype', '?')}{list(shape)}"
    return type(x).__name__


def _digest_streams(encoder_cls):
    """Give every reference Encoder a digest of its params and of each
    call to encode() with its frame; list the encoders of the test."""
    init, encode = encoder_cls.__init__, encoder_cls.encode

    def spy_init(self, params=None, *a, **kw):
        self._meter_digest = hashlib.sha1(repr(params).encode())
        _streams.append(self)
        return init(self, params, *a, **kw)

    def spy_encode(self, frame, *a, **kw):
        d = getattr(self, "_meter_digest", None)
        if d is not None:
            import numpy as np
            self._meter_frames = getattr(self, "_meter_frames", 0) + 1
            d.update(repr((a, sorted(kw.items()))).encode())
            for plane in (frame.y, frame.u, frame.v):
                d.update(np.asarray(plane).tobytes())
        return encode(self, frame, *a, **kw)

    encoder_cls.__init__, encoder_cls.encode = spy_init, spy_encode


class _Spy:
    """Calls the core and records its key; every other attribute is the
    core's own."""

    def __init__(self, name, core):
        self._name, self._core = name, core

    def __call__(self, *args, **kw):
        _keys.add(f"{self._name}(" + ",".join(
            [_sig(a) for a in args]
            + [f"{k}={_sig(v)}" for k, v in sorted(kw.items())]) + ")")
        return self._core(*args, **kw)

    def __getattr__(self, attr):
        return getattr(self._core, attr)


def _thread_cpu():
    """(main thread, other threads) CPU seconds of this process; the
    other threads' include those that have ended (a test's own threads,
    such as the g++ builds of the CUDA sources that run a thread per CUDA
    thread)."""
    with open(f"/proc/self/task/{os.getpid()}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    main = (int(fields[11]) + int(fields[12])) / _TICK
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return main, ru.ru_utime + ru.ru_stime - main


def pytest_sessionstart(session):
    """In each process that runs tests (not xdist's controller): listen
    to JAX and wrap the cores, before any test module is imported."""
    config = session.config
    if (getattr(config.option, "dist", "no") != "no"
            and not hasattr(config, "workerinput")):
        return
    import jax
    import jax.monitoring
    jax.monitoring.register_event_duration_secs_listener(_listener)
    clear = jax.clear_caches

    def counted_clear():
        _acc["clears"] += 1
        return clear()
    jax.clear_caches = counted_clear
    _digest_streams(importlib.import_module("x264_tpu.api").Encoder)
    for mod_name, names in _CORES.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            setattr(mod, name, _Spy(name.lstrip("_"), getattr(mod, name)))


def _maps_held():
    with open("/proc/self/maps", "rb") as f:
        return f.read().count(b"\n")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    _maps["start"] = _maps_held()
    yield
    _maps["end"] = _maps_held()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    before, cpu0 = dict(_acc), _thread_cpu()
    start, t0 = time.time(), time.perf_counter()
    _keys.clear()
    _maps.clear()
    _streams.clear()
    yield
    wall, cpu1 = time.perf_counter() - t0, _thread_cpu()
    row = {"test": item.nodeid,
           "worker": os.environ.get("PYTEST_XDIST_WORKER", "main"),
           "start": round(start, 3), "wall": round(wall, 3),
           "cpu_main": round(cpu1[0] - cpu0[0], 2),
           "cpu_other": round(cpu1[1] - cpu0[1], 2),
           "peak_rss_mib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss // 1024}
    row.update({k: round(_acc[k] - before.get(k, 0.0), 3)
                for k in _EVENTS.values()})
    row.update({k: int(_acc[k] - before.get(k, 0)) for k in _TALLIES})
    row["maps"] = [_maps.get("start"), _maps.get("end")]
    row["ref_streams"] = sorted({e._meter_digest.hexdigest()[:16]
                                 for e in _streams
                                 if getattr(e, "_meter_frames", 0)})
    row["keys"] = sorted(_keys)
    with open(os.environ.get("SUITE_METER", "suite_meter.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")


def _side(nodeid):
    return "port" if "test_torch_" in nodeid.split("::")[0] else "reference"


def summarize(path, top=25):
    """Sum the lines by test file and by the reference's files against
    the port's (``test_torch_*``); then the slowest tests, the workers'
    ends and the core keys only the port's tests meet."""
    keys = ("wall", "compile", "trace", "lower", "read", "cpu_main",
            "cpu_other")
    counts = ("programs", "compiled", "big_programs", "clears")
    by_file = collections.defaultdict(collections.Counter)
    rows, met = [], collections.defaultdict(set)
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            rows.append(row)
            name = row["test"].split("::")[0]
            side = _side(name)
            row["compiled"] = row.get("programs", 0) - row.get(
                "cache_reads", 0)
            for target in (name, side):
                for k in keys + counts:
                    by_file[target][k] += row.get(k, 0)
            by_file[name]["n"] += 1
            by_file["peak"]["rss"] = max(by_file["peak"]["rss"],
                                         row.get("peak_rss_mib", 0))
            for k in row.get("keys", ()):
                met[k].add(row["test"])
    peak = by_file.pop("peak")["rss"]
    print(f"largest worker's peak resident size: {peak} MiB")
    print("seconds summed over the workers: " + " ".join(keys)
          + "; programs met, compiled, compiled or read in 1 s or more;"
          " JAX cache clears")
    for name, c in sorted(by_file.items(), key=lambda kv: -kv[1]["wall"]):
        print(f"{name:46s} " + " ".join(f"{c[k]:8.1f}" for k in keys)
              + "".join(f" {c[k]:6d}" for k in counts)
              + (f" {c['n']:4d} tests" if c["n"] else ""))

    print(f"\nthe {top} slowest tests: wall, JAX (compile + trace + lower),"
          " programs met, compiled, worker")
    for row in sorted(rows, key=lambda r: -r["wall"])[:top]:
        jax_s = row["compile"] + row["trace"] + row["lower"]
        print(f"{row['wall']:8.1f} {jax_s:8.1f} {row.get('programs', 0):5d}"
              f" {row['compiled']:5d} {row.get('worker', '?'):5s}"
              f" {row['test']}")

    if rows and "start" in rows[0]:
        t0 = min(r["start"] for r in rows)
        last = {}
        for row in rows:
            end = row["start"] + row["wall"]
            if end >= last.get(row["worker"], (0, None))[0]:
                last[row["worker"]] = (end, row)
        print("\nworkers by end (seconds after the first test started):"
              " its last test, that test's start and wall")
        for worker, (end, row) in sorted(last.items(),
                                         key=lambda kv: kv[1][0]):
            print(f"{worker:5s} {end - t0:8.1f}  {row['test']}"
                  f" (from {row['start'] - t0:.1f}, {row['wall']:.1f} s)")

    streams = collections.defaultdict(set)
    for row in rows:
        if _side(row["test"]) == "port":
            for s in row.get("ref_streams", ()):
                streams[s].add(row["test"])
    again = {s: t for s, t in streams.items() if len(t) > 1}
    print(f"\nreference streams the port's tests encode: {len(streams)};"
          f" met by more than one test: {len(again)}")
    for s, tests in sorted(again.items()):
        print(f"  {s}: " + ", ".join(sorted(tests)))

    port_only = {k: tests for k, tests in met.items()
                 if all(_side(t) == "port" for t in tests)}
    shared = sum(1 for tests in met.values()
                 if {_side(t) for t in tests} == {"port", "reference"})
    print(f"\ncore keys met: {len(met)}; by both sides {shared}; by the"
          f" port's tests only {len(port_only)}, with the tests that meet"
          " them:")
    for k, tests in sorted(port_only.items()):
        print(f"  {k}")
        for t in sorted(tests):
            print(f"      {t}")


if __name__ == "__main__":
    summarize(sys.argv[1])
