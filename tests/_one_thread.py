"""torch and numpy's BLAS on one thread in the port's tests.

The suite runs in several xdist workers on one machine, and each
worker's torch (OpenMP) and numpy (OpenBLAS) start thread pools as wide
as the machine.  Between the port's many small CPU ops those threads
spin, and they crowd out the other workers, the reference's XLA compiles
among them.  On an 8-core machine, tests/test_torch_t8_streams.py on 6
workers took 141 s and 12.3 CPU-minutes with the default pools, 79 s
and 5.4 with this module.  Importing it sets one thread for the whole
process (every worker imports every test module while it collects)."""

import torch

torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:             # torch's own setting still holds
    pass
else:
    threadpool_limits(limits=1)
