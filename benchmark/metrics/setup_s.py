"""Seconds from the process's start to the window's start: imports, the
build (only the first run in a checkout compiles), the inputs and the
warm-up calls."""


def read(rec):
    return rec['setup_s']
