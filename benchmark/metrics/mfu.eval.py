"""mfu.eval (%): the eval forward's least time at the card's peaks, from
the traced pairs' shapes (``harness/work.py::eval_forward_seconds``, the
attention's products at the precision the configuration states), over the
traced window's wall time. Layer: the model, ``PointDSC.forward``."""

from harness import work


def read(record, cell):
    t = record.get("trace")
    if not t or not record["shapes"] or t["window_s"] <= 0:
        return None
    prec = cell.config["precision"]["eval"]
    least = sum(work.eval_forward_seconds(n, cell.config["model"], prec)
                for n in record["shapes"])
    return least / t["window_s"] * 100.0
