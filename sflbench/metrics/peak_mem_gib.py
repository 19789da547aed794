"""Peak device memory of the window: ``torch.cuda.max_memory_allocated()``
after a reset at the window's start, in GiB. It is read in the traced
run, whose profiler holds its buffers in host memory. It is not an
end-to-end metric: the granite fp32 cell reads 35.69 GiB in most runs
and 3 to 9.5 GiB more in a few, a seed that read high once reading low
the next time, and a step's peak in one process varies alike; no bound
holds such a reading. A lower peak
lets a card hold more clients or a larger batch, more tokens a step:
moves ``train_tokens_per_s``.
"""

LAYER = "device memory, torch's caching allocator"
UNIT = "GiB"
MOVES = "train_tokens_per_s"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
