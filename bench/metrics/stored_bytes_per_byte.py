"""Growth of the nodes' pieces and the index, per logical byte acknowledged."""


def read(run):
    if not run.put_bytes:
        return None
    return (run.stored_after - run.stored_before) / run.put_bytes
