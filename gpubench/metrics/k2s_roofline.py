"""K2s's share of its roofline, in %: its least time at the cell's
split-ring step shape (gpubench/yardstick.py, published H100 peaks) over
its mean time a launch in the trace.  Nothing where the cell does not run
K2s."""


def read(t):
    return t.roofline_pct("k2s")
