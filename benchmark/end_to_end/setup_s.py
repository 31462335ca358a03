"""Seconds from the process's start until the window opens: imports,
loading the kernel library (building it, in a checkout's first run:
compilation belongs to set-up), making the tables on the card, and one
warm query of each type."""


def read(w):
    return w.t_open - w.t_start
