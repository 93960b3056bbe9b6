"""Cap torch's intra-op threads in a pytest-xdist worker.

Every `tests/test_torch_port_*.py` imports this module first. Under xdist
each worker process would otherwise start one OpenMP thread per core,
so six workers on eight cores run 48 threads: measured on an 8-core
machine, six copies of the phase-10 rehearsal at torch's default did
not finish in 240 s, against 31-35 s each with one thread a worker.
A worker gets its share of the cores (at least one); a plain
`pytest` run, and every process outside the tests, keeps torch's
default.
"""

import os

import torch


def worker_threads():
    """Threads a worker should use, or None outside pytest-xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers < 2 or "PYTEST_XDIST_WORKER" not in os.environ:
        return None
    return max(1, len(os.sched_getaffinity(0)) // workers)


_N = worker_threads()
if _N is not None and torch.get_num_threads() != _N:
    torch.set_num_threads(_N)
