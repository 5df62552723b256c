import threading


class Entry:
    def __init__(self):
        self.lock = threading.Lock()
        self.active = None

    def swap(self, dep):
        with self.lock:
            self.active = dep


def active_version(entry):
    if entry.active is not None:
        # a concurrent swap/undeploy can null entry.active between
        # the check and this second read
        return entry.active.version
    return None
