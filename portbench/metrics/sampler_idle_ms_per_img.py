"""The card's idle time inside the MaskGIT sampler an image: the parts
of the program's ``maskgit.generate`` spans on the window's thread,
clipped to the window, in which no operation ran on the card, over the
window's images."""


def read(run):
    t = run.trace
    if t is None or not run.images:
        return None
    spans = [(max(float(e["ts"]), t.t0), min(float(e["ts"]) + float(e["dur"]), t.t1))
             for e in t.ranges if e["name"] == "maskgit.generate" and e["tid"] == t.main_tid]
    spans = [(a, b) for a, b in spans if b > a]
    if not spans:
        return None
    busy = t.busy()
    idle = sum((b - a) - sum(max(0.0, min(b, d) - max(a, c)) for c, d in busy)
               for a, b in spans)
    return 1e-3 * idle / run.images
