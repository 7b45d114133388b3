"""setup_s: from process start to the window's start (loading, drawing the
weights, building the server, warming the cell's shapes, the pre-roll)."""


def read(run):
    return run["setup_s"]
