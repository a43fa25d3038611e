"""The host coder's time in the entropy chain an image: the program's
``h_rans.code`` spans (the native coder's calls, and waits on the pool
threads that run it) on the window's thread, clipped to the window, over
the window's images.  Spans on other threads are the coder's own calls
there, already waited for here: they are not counted."""


def span_ms_per_img(run, name: str):
    """Host ms an image inside the ranges named ``name`` on the window's
    thread, clipped to the window (nested or overlapping ranges once);
    None where there is none."""
    t = run.trace
    if t is None or not run.images:
        return None
    spans = sorted((max(float(e["ts"]), t.t0), min(float(e["ts"]) + float(e["dur"]), t.t1))
                   for e in t.ranges if e["name"] == name and e["tid"] == t.main_tid)
    spans = [(a, b) for a, b in spans if b > a]
    if not spans:
        return None
    total, end = 0.0, t.t0
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return 1e-3 * total / run.images


def read(run):
    return span_ms_per_img(run, "h_rans.code")
