"""Queries completed over the seconds of the whole window: from its
opening until the last query issued in it is complete, over all
streams."""


def read(w):
    return w.completed / (w.t_close - w.t_open)
