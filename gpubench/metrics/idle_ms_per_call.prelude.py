"""The device's idle time a call before it reaches the blind rotation's
steps (``apply_gates``' entry, the linear combination and its table
copies, ``modswitch``, the test vector's rotation by NTT), in ms: idle
gaps whose midpoint lies in a call's device interval before that of its
``blind_rotate.steps`` span, both placed by their CUDA event pairs
(gpubench/program.py)."""

from gpubench import program


def read(t):
    return program.idle_ms_per_call(t, "prelude")
