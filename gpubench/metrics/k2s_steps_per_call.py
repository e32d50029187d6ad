"""Blind-rotation steps a call that ran on K2s, the split-ring step
kernel: its wrapper's launches over the traced stretch
(``Trace.launched``) divided by the calls.  0 where a split-ring
configuration's scan falls back to the plain ops; nothing on a
configuration without the split ring."""


def read(t):
    n = t.launched.get("k2s", 0)
    if n == 0 and not t.cfg.get("split_ring"):
        return None
    return n / t.calls
