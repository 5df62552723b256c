import threading


class Server:
    def __init__(self, fn):
        self._lock = threading.Lock()
        self._fn = fn
        self.last = None

    def refresh(self, x):
        out = self._fn(x).cpu()  # device work unlocked
        with self._lock:
            self.last = out
        return self.last
