"""The entropy chain's blocking copies to the host an image: the
program's ``h_rans.fetch`` spans (each step's index planes, the packed
planes, the kernel coder's words) on the window's thread, clipped to the
window, over the window's images.  A copy waits for the work queued
before it, so this is the chain's wait for the card as well."""
from portbench.metrics.h_code_ms_per_img import span_ms_per_img


def read(run):
    return span_ms_per_img(run, "h_rans.fetch")
