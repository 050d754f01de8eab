"""graph_capture_s: the benchmark's span around the set-up's first LM fit,
which captures the fit's CUDA graph; read only where the program's counter
``graphs.CAPTURES`` shows exactly one capture of the fit's graph in it."""


def read(trace):
    setup = trace.setup
    if setup.get("graph_captures") != 1:
        return None
    return setup["graph_capture_s"]
