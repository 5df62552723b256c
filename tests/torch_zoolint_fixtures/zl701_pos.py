import threading


class Pool:
    def __init__(self):
        self._sem = threading.Semaphore(4)

    def serve(self, work):
        self._sem.acquire()
        try:
            return work()
        finally:
            pass  # no release: an exception in work() leaks the slot
