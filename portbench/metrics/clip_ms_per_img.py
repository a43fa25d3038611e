"""The CLIP image tower's host time an image: the program's
``clip.embed`` spans (preprocessing, the tower at batch 1 and the
vector's copy to the host) on the window's thread, clipped to the
window, over the window's images."""
from portbench.metrics.h_code_ms_per_img import span_ms_per_img


def read(run):
    return span_ms_per_img(run, "clip.embed")
