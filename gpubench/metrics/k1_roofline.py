"""K1's share of its roofline, in %: its least time at the cell's step
shape (gpubench/yardstick.py, published H100 peaks) over its mean time a
call in the trace.  Nothing where the cell does not run K1."""


def read(t):
    return t.roofline_pct("k1")
