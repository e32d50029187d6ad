"""The key switch's own device time a call, in ms: the time the device
ran kernels inside the device intervals of the ``bootstrap.key_switch``
spans (``ops/keyswitch.py:identity_key_switch``, placed by their CUDA
event pairs), idle gaps left out, summed over the stretch and divided by
the calls (gpubench/program.py)."""

from gpubench import program


def read(t):
    return program.busy_ms_per_call(t, "bootstrap.key_switch")
