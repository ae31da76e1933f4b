"""k1_roofline: kernel K1 (ops/block_tally, csrc/block_tally.cu) against
its roofline, in % (kernel_work)."""

from benchmark.metrics import kernel_work

UNIT = "%"


def read(run):
    return kernel_work.roofline_pct(run, "block_tally_kernel", "k1_launches",
                                   expands=False)
