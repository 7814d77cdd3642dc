"""Repository-wide pytest setup, loaded before any test module: OpenMP
threads that wait passively.

PyTorch's CPU operations (the port's tests, tests/test_torch_*.py) run on
an OpenMP team of as many threads as the host has cores, in every
pytest-xdist worker.  By default each thread of a team spins for a while
after every parallel region; with several workers on one host, those spins
take most of the CPU and starve the threads that have work
(scripts/torch_test_wait_policy.py measures both policies).

OpenMP reads the policy once, when torch loads its runtime, and the first
test module to import torch does so while pytest collects; so it is set
here, before collection, and inherited by the workers and by the processes
the tests start.  The policy changes how idle threads wait, not how many
threads there are or what they compute.  A policy set in the environment
wins.
"""

import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
