"""The CPU thread policy of the port's tests: torch runs on one intra-op
thread.

Every tests/test_torch_*.py imports this module, so a file run alone and
every pytest-xdist worker (each imports every test module while
collecting) run torch on one thread. A port frame on the CPU is
thousands of small ops; with the suite's workers on every core, each
worker's default pool (one thread per core) turns every op into a wait
for busy cores. On an 8-core host running the suite on 6 workers, the
port's files summed 6,625 s of test time with the default pools and 966 s
on one thread each (test_torch_secondary 914.8 s -> 123.9 s,
test_torch_raster_frames 754.2 s -> 48.7 s);
test_frame_matches_the_plain_reference[0-0] took 343 s in the suite and
3.9 s alone.

OMP_NUM_THREADS is set too, unless already set, for the processes the
tests start and for an OpenMP library loaded later (the native oracle).
This module imports no JAX: tests/test_torch_import.py holds the port to
that.
"""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)
