import threading


class Pool:
    def __init__(self):
        self._sem = threading.Semaphore(4)

    def serve(self, work):
        self._sem.acquire()
        try:
            return work()
        finally:
            self._sem.release()  # every exit path, unwind included

    def handoff(self):
        # returning while holding is ownership transfer, not a leak
        self._sem.acquire()
        return self._sem
