import os


def home_dir():
    # non-ZOO names are outside the contract: read them however
    return os.environ.get("HOME", "/home")
