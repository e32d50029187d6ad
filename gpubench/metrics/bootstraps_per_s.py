"""Bootstrapped lanes completed in the window over the window's seconds
(host clock; the window ends on the first call to finish after its
length)."""


def read(w):
    return w.lanes * w.calls / w.window_s
