"""peak_mem_gib: torch.cuda.max_memory_allocated over the whole run, set-up
and window, in GiB (read on the card once the window has closed)."""

UNIT = "GiB"


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
