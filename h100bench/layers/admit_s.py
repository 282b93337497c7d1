"""Seconds of the host clock around the program's admission of the graph
(its adjacency preparation and the registry's admit or admit_pair)."""


def read(t):
    return t.admit_s
