import threading


class Server:
    def __init__(self, fn):
        self._lock = threading.Lock()
        self._fn = fn
        self.last = None

    def refresh(self, x):
        with self._lock:
            # every caller contending _lock now waits on device latency
            self.last = self._fn(x).cpu()
        return self.last
