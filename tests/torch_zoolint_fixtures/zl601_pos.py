"""ZL601 positive: bare print / stdlib logging inside hot functions."""
import logging

log = logging.getLogger("fixture")


def predict(x):
    print("serving", x)          # ZL601: print on the hot path
    return x


def _loop(q):
    for item in q:
        log.info("dispatching %s", item)  # ZL601: stdlib logging
