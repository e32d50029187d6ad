"""Synchronising CUDA operations a call on the gate path: copies of host
memory to the card and reads of device values, each of which makes the
host wait for the stream to drain.  The calls' outermost spans (the
kind's ``CALL_SPAN``: ``gates.apply`` on the gate path) count them with
torch's sync debug mode (``syncs``); summed over the stretch and divided
by the calls (gpubench/program.py)."""

from gpubench import program


def read(t):
    return program.syncs_per_call(t)
