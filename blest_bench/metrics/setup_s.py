"""Process start to the first timed batch: imports, graph generation, the
port's preparation (GraphSession), the kernel build or load, one warm batch."""


def read(rec: dict):
    return rec["setup_s"]
