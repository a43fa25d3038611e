"""The U-ViT's long skips' device time an image: operations launched
inside the port's ``maskgit.uvit.skip`` spans (each out block's
concatenation and skip projection), over the window's images."""


def read(run):
    t = run.trace
    if t is None or not run.images:
        return None
    s = t.range_device_s(("maskgit.uvit.skip",))
    return 1000.0 * s / run.images if s > 0 else None
