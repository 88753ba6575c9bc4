"""launches.eval (ops/pair): device operations (kernels, copies, sets) the
profiler saw in the traced window, over the pairs traced. Layer: the entry,
``eval/runner.py::Evaluator`` and ``models/pointdsc.py``."""


def read(record, cell):
    t = record.get("trace")
    if not t or not t["ops"] or not record["traced_items"]:
        return None
    return t["ops"] / record["traced_items"]
