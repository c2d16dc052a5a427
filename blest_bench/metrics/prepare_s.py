"""Host clock around ``GraphSession(...)``, ended by a device synchronise:
ordering, BVSS build and upload."""


def read(rec: dict):
    return rec["prepare_s"]
