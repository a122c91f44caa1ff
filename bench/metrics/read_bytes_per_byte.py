"""Piece bytes the window's gets read from the nodes, per byte returned."""


def read(run):
    got = run.state.get("node_read_bytes")
    if not got or not run.get_bytes:
        return None
    return got / run.get_bytes
