"""k2_roofline: kernel K2 (ops/fast_tally, csrc/fast_tally.cu) against its
roofline, in % (kernel_work)."""

from benchmark.metrics import kernel_work

UNIT = "%"


def read(run):
    return kernel_work.roofline_pct(run, "fast_tally_kernel", "k2_launches",
                                   expands=True)
