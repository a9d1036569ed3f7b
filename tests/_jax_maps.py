"""Frees the reference's compiled JAX programs between the port's tests.

Every XLA:CPU executable holds three memory mappings (code, constants,
data), and JAX keeps every program it has compiled.  The port's tests
drive the reference at many shapes: one stream test adds up to 7000
mappings, so an xdist worker that runs a few dozen of them reaches the
kernel's `vm.max_map_count` (65530 by default), and the next compile,
compile-cache read or compile-cache write segfaults.

A test module that calls the reference imports `free_jax_executables`.
Before and after each of its tests, once the process holds more than a
quarter of the limit, the fixture clears JAX's caches, which unmaps the
programs; the next call recompiles, or reads the persistent compile
cache.  Clearing before a test matters as much as after it: the
reference's own test files run on the same xdist workers without this
fixture, and one worker was seen to reach 65475 mappings in them
(test_mux.py after test_mbtree.py), so a port test arriving there had
no room for its own compiles.

Importing the module also sends every program the worker compiles to
JAX's persistent compile cache, not only those that took a second or
more (x264_tpu/__init__.py sets the cache and that threshold): a
program freed here, or compiled by another worker on the same cache, is
then read back instead of compiled again.  The executables are the
same, so no result changes.  In a run of the whole suite on an 8-core
machine with an empty cache, 2846 programs were read back where 356
were with the one-second threshold, and JAX counted 3635 s of compiles
saved against 3220 s."""

import gc

import jax
import pytest

import x264_tpu  # noqa: F401  (sets the cache and its threshold first)

jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def _map_limit():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


MAP_LIMIT = _map_limit()


def maps_held():
    with open("/proc/self/maps", "rb") as f:
        return f.read().count(b"\n")


def free_if_crowded(limit=MAP_LIMIT):
    """Clear JAX's caches when the process holds more than limit // 4
    mappings; True when it did."""
    if limit is None or maps_held() <= limit // 4:
        return False
    jax.clear_caches()
    gc.collect()
    return True


def cleared_around(limit=MAP_LIMIT):
    """free_if_crowded before a test and again after it: a generator
    whose one yield is the test."""
    free_if_crowded(limit)
    yield
    free_if_crowded(limit)


@pytest.fixture(autouse=True)
def free_jax_executables():
    yield from cleared_around()
