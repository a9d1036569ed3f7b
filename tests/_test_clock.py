"""A time limit for each of the port's tests.

A port test module imports ``per_test_clock``, an autouse fixture.  At
``LIMIT_S`` seconds a SIGALRM fails the test with its traceback (the
alarm's Python handler raises where the test is).  A test stuck in C
code, where no Python handler runs (a lock, a wait on a subprocess or a
thread inside an extension), is caught ``GRACE_S`` seconds later by
faulthandler's watchdog thread: it writes every thread's stack to
stderr and ends the worker, which xdist reports as a failure of that
test.  So a hung test lowers the count of passes and cannot hold the
suite to its own time limit.

The limit is a guard, not a budget: it is set far above what the slowest
port test takes on an 8-core machine under six xdist workers, the
reference's compiles included (``--durations=0`` prints each test's
time)."""

import faulthandler
import signal
import threading

import pytest

LIMIT_S = 900.0
GRACE_S = 60.0


class ClockExpired(Exception):
    """A test ran past ``LIMIT_S``."""


@pytest.fixture(autouse=True)
def per_test_clock(request):
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        raise ClockExpired(f"{request.node.nodeid} ran past its limit "
                           f"of {LIMIT_S:.0f} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    faulthandler.dump_traceback_later(LIMIT_S + GRACE_S, exit=True)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, old)
