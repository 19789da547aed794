"""torch's CPU ``exp``: the first parallel call of a process, pinned.

On an x86-64 CPU with AVX-512 (torch 2.13.0+cpu, MKL 2024.2), the first
parallel ``exp`` of a fresh process is in some processes off by ~1.5e-4
relative on the chunks of one or more worker threads (at 8 threads, an
eighth of the tensor each); it was seen only while the machine was busy.
A float32 ``exp`` is otherwise good to a few ulp (6e-8 each). The calls
after it are exact, on the same thread team and on a fresh Python
thread's own team, and a process with one thread shows nothing. The
port's CPU parity tests hold torch to the reference at 1e-4 and tighter,
so each of their files runs torch on one thread (the module fixture
``_one_torch_thread`` of ``tests/_torch_threads.py``).

The test below holds the facts that rule relies on in fresh
interpreters: the first call stays within 1e-3 relative, every later call
within 1e-6, and one thread within 1e-6 from the start. The first call's
fault itself comes and goes from process to process, so it is counted,
not asserted. To see whether a torch or MKL upgrade still shows it:

    python tests/test_torch_cpu_exp.py 40   # how many of 40 did, and where
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

EXACT = 1e-6        # far above a few ulp, far below the fault
FIRST_BOUND = 1e-3  # the fault's size, with room
PROCESSES = 3

CHILD = r"""
import threading
import numpy as np
import torch

x = np.random.RandomState(0).randn(1 << 20).astype(np.float32) * 3
want = np.exp(x.astype(np.float64))

def err():
    got = torch.exp(torch.from_numpy(x)).double().numpy()
    return np.abs(got - want) / want

first = err()
off = np.nonzero(first >= 1e-6)[0]
errs = {"first": first.max(), "second": err().max(),
        "lo": off.min() if off.size else -1,
        "hi": off.max() if off.size else -1, "n": x.size}
t = threading.Thread(target=lambda: errs.__setitem__("thread",
                                                     err().max()))
t.start()
t.join()
print(" ".join(f"{k}={float(v)!r}" for k, v in errs.items()))
"""


def fresh_process_errors(threads=None):
    """Relative errors of the first and second parallel ``exp`` and of one
    on a fresh Python thread, in a new interpreter; ``lo``/``hi`` bound
    the first call's elements that are off (-1 if none) out of ``n``."""
    env = dict(os.environ)
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    return {k: float(v) for k, v in
            (kv.split("=") for kv in out.split())}


def test_exp_is_exact_after_the_first_parallel_call():
    for _ in range(PROCESSES):
        e = fresh_process_errors()
        assert e["first"] < FIRST_BOUND, e
        assert e["second"] < EXACT, e
        assert e["thread"] < EXACT, e


def test_exp_on_one_thread_is_exact_from_the_start():
    e = fresh_process_errors(threads=1)
    assert max(e["first"], e["second"], e["thread"]) < EXACT, e


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    runs = [fresh_process_errors() for _ in range(n)]
    faulty = [e for e in runs if e["first"] >= EXACT]
    for e in faulty:
        print(f"first {e['first']!r} relative on elements "
              f"{int(e['lo'])}..{int(e['hi'])} of {int(e['n'])}; "
              f"second {e['second']!r}, fresh thread {e['thread']!r}")
    print(f"first parallel exp off by >= {EXACT:g} relative in "
          f"{len(faulty)} of {n} processes; largest "
          f"{max(e['first'] for e in runs)!r}")
