import os


def resident_budget():
    # a ZOO_* knob read wherever os.environ was handy: undeclared,
    # undocumented, invisible to the contract snapshot
    return os.environ.get("ZOO_FAKE_RESIDENT")
