"""Seconds a test file takes in a pytest run, from the run's JUnit XML.

Sums each file's test cases (set-up, call and tear-down, pytest's default
``junit_duration_report``) and prints the total, the port's share
(``test_torch_*``) and the ``--top`` files by seconds with their counts of
tests and passes.  Under ``--dist loadfile`` a file runs whole on one
worker, so its sum is the seconds it held that worker.

    python3 scripts/torch_junit_files.py <run.xml> [--top 20]
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def file_seconds(path):
    """{file: [seconds, tests, passed]} of a JUnit XML."""
    out = collections.defaultdict(lambda: [0.0, 0, 0])
    for case in ET.parse(path).getroot().iter("testcase"):
        row = out[case.get("classname", "?").split(".")[-1]]
        row[0] += float(case.get("time", 0))
        row[1] += 1
        row[2] += not any(child.tag in ("failure", "error", "skipped") for child in case)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("xml")
    parser.add_argument("--top", type=int, default=20)
    opts = parser.parse_args()
    rows = file_seconds(opts.xml)
    total = sum(r[0] for r in rows.values())
    port = sum(r[0] for f, r in rows.items() if f.startswith("test_torch_"))
    print(f"worker-seconds {total:.0f}, port {port:.0f}, passed {sum(r[2] for r in rows.values())}")
    for name, (seconds, tests, passed) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:opts.top]:
        print(f"{name:40s} {seconds:8.1f} s {tests:4d} tests {passed:4d} passed")


if __name__ == "__main__":
    main()
