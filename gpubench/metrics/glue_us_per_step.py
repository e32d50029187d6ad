"""Device time of the blind-rotation engine's glue a step, in us: every
kernel that is not a hand kernel (decompose, limb planes, cat, the key
switch, the linear combination), summed over the traced stretch and
divided by the steps counted on K1's launch counter."""

from gpubench.system import HAND_KERNELS

SYMBOLS = tuple(sym for _, _, sym in HAND_KERNELS.values())


def read(t):
    steps = t.launched["k1"]
    if not steps:
        return None
    glue = sum(e - s for nm, s, e in t.records
               if not any(sym in nm for sym in SYMBOLS))
    return glue / 1e3 / steps
