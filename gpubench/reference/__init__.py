"""Plain references that decide a run's ``correct``: NumPy only, nothing of
the program under test."""
