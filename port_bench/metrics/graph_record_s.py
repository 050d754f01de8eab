"""graph_record_s: the stream capture and instantiation of the set-up's
capture of the LM fit's graph, from the program's counter
``graphs.RECORD_S``; read only where the set-up's first fit captured the
fit's graph once (``graphs.CAPTURES``, as ``graph_capture_s`` reads it) and
the process captured no other graph."""


def read(trace):
    from stochvolmodels_torch.ops import graphs

    seconds = getattr(graphs, "RECORD_S", None)
    if (trace.setup.get("graph_captures") != 1 or seconds is None
            or sum(graphs.CAPTURES.values()) != 1 or len(seconds) != 1):
        return None
    return next(iter(seconds.values()))
