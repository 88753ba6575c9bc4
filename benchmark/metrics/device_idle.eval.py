"""device_idle.eval (%): the share of the traced window in which no device
operation ran (the complement of the union of their intervals)."""


def read(record, cell):
    t = record.get("trace")
    if not t or not t["ops"] or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
