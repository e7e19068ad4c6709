"""polys_per_s: polynomials completed by the window's calls over the
window's seconds: all the work over all the time."""


def read(run):
    if not run.calls:
        return None
    return sum(polys for _, _, polys in run.calls) / run.window_s
