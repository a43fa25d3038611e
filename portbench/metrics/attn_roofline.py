"""The least time the window's attention needs (each call's FLOPs over the
peak of the cell's precision or its bytes, read and written once, over
HBM's rate; counted from the configuration's shapes), over the device
time of the port's attention kernels in the trace."""
import re

from portbench.harness.peaks import attention_least_s

KERNELS = re.compile(r"\b(seq|window)_attention(_gsd)?_kernel\b")


def read(run):
    t = run.trace
    if t is None or not run.attention_per_image or not run.images:
        return None
    spent = t.kernel_s(lambda name: bool(KERNELS.search(name)))
    if spent <= 0:
        return None
    return 100.0 * attention_least_s(run.attention_per_image, run.dtype) * run.images / spent
