import threading


class Entry:
    def __init__(self):
        self.lock = threading.Lock()
        self.active = None

    def swap(self, dep):
        with self.lock:
            self.active = dep


def active_version(entry):
    dep = entry.active  # single read: snapshot, then check the local
    if dep is not None:
        return dep.version
    return None
