"""CPU cost of OpenMP's wait policy on the port's CPU tests under load.

Starts ``--procs`` pytest processes of the same test selection at once,
first with the OpenMP runtime's default policy (its threads spin after each
parallel region) and then with ``OMP_WAIT_POLICY=PASSIVE`` (the policy the
repository's conftest.py sets), and prints one JSON line a round: its wall
seconds, the CPU seconds of its processes and their pytest summaries.  Both
rounds skip the root conftest.py (``--confcutdir tests``), so the policy is
the environment's alone.

    python3 scripts/torch_test_wait_policy.py [--procs 6] [pytest args ...]

Without pytest arguments it runs torch-heavy tests of the port: the train
runner in every runner check of tests/test_torch_serving.py and the
emulated bf16 kernel of tests/test_torch_sparse_wgmma.py.  Run it from the
repository's root on an otherwise idle host.
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ["tests/test_torch_sparse_wgmma.py", "-k", "within_one_ulp or float64",
           "tests/test_torch_serving.py::test_method_is_checked_in_every_runner"]


def run_round(procs, args, policy):
    env = {k: v for k, v in os.environ.items() if k != "OMP_WAIT_POLICY"}
    env["JAX_PLATFORMS"] = "cpu"
    if policy is not None:
        env["OMP_WAIT_POLICY"] = policy
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--confcutdir", "tests", *args]
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    running = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for _ in range(procs)]
    outputs = [p.communicate()[0] for p in running]
    wall = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = (after.ru_utime - before.ru_utime) + (after.ru_stime - before.ru_stime)
    summaries = [out.strip().splitlines()[-1] if out.strip() else "" for out in outputs]
    return {"policy": policy or "default", "procs": procs, "wall_s": round(wall, 1), "cpu_s": round(cpu, 1),
            "rcs": [p.returncode for p in running], "summaries": summaries}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--procs", type=int, default=6)
    opts, pytest_args = parser.parse_known_args()
    for policy in (None, "PASSIVE"):
        print(json.dumps(run_round(opts.procs, pytest_args or DEFAULT, policy)), flush=True)


if __name__ == "__main__":
    main()
