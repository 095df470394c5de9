"""The torch thread cap of the port's heavy test files.

The tier-1 command runs six test processes (``-n 6``) on the machine's
cores; a process that keeps torch's default thread count (every core)
oversubscribes them, and each heavy file then runs several times its
serial time. Under xdist a file takes at most its share of the cores (and
no fewer than two threads); run alone, it takes up to ``n``.
"""
import os


def thread_budget(n: int) -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    if workers <= 1:
        return n
    return max(2, min(n, (os.cpu_count() or 1) // workers))


def capped_threads(n: int):
    """A generator fixture body: torch's threads capped while it is open."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(min(thread_budget(n), saved))
    try:
        yield
    finally:
        torch.set_num_threads(saved)
