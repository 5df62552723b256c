import threading


class Router:
    def __init__(self):
        self._route_lock = threading.Lock()
        self._table_lock = threading.Lock()

    def update(self):
        with self._route_lock:
            with self._table_lock:
                pass

    def lookup(self):
        # opposite order: two threads deadlock on each other's
        # second acquisition
        with self._table_lock:
            with self._route_lock:
                pass
