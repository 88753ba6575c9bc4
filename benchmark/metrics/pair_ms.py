"""pair_ms (ms, host clock): the window's time over the pairs it completed,
one pair at a time in a closed loop."""


def read(record, cell):
    return record["window_s"] / record["items"] * 1e3 if record.get("items") else None
