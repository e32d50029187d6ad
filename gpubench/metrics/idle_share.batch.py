"""The device's idle share over the traced stretch, in %: 1 - busy / device
span, busy being the union of the kernels' spans and the span running
from the first kernel's start to the last one's end."""


def read(t):
    return t.idle_share_pct()
