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
        # same global order everywhere: no cycle
        with self._route_lock:
            with self._table_lock:
                pass
