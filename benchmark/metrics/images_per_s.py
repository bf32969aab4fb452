"""Images completed in the window divided by the window's seconds."""


def read(r):
    return r.images / r.window_s
