"""setup_s (s, host clock): from the start of the run's process to the
first timed pair: imports, the CUDA context, the kernel libraries, the
weights, the traffic, the guard's probes where the softmax has them, and
the warm-up."""


def read(record, cell):
    return record["setup_s"]
