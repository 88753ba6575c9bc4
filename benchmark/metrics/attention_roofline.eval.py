"""attention_roofline.eval (%): the least time of the eval encoder's
attentions (the two N^2 C products of each layer, from the traced pairs'
shapes, at the precision the configuration states:
``harness/work.py::attention_seconds``) over the device time of the cached
running-max attention kernels named below. A run whose attention took
another kernel leaves them silent, and then nothing is read. Layer: the
kernels, ``kernels/sc_attention.py::fused_sc_attention_cached``."""

from harness import work

KERNELS = ("sc_attention_cached_kernel", "sc_attention_wide_kernel<true")


def read(record, cell):
    t = record.get("trace")
    if not t or not record["shapes"]:
        return None
    device_s = sum(s for name, s in t["op_times"].items() if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    m, prec = cell.config["model"], cell.config["precision"]["eval"]
    least = sum(work.attention_seconds(n, m["num_channels"], m["num_layers"], prec)
                for n in record["shapes"])
    return least / device_s * 100.0
