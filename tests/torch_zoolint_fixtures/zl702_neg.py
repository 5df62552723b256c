import threading


class Admission:
    def __init__(self):
        self._cond = threading.Condition()
        self._waiting = 0
        self._granted = False

    def acquire_seat(self, deadline):
        with self._cond:
            self._waiting += 1
            try:
                while not self._granted:
                    if deadline <= 0:
                        raise TimeoutError("deadline lapsed waiting")
                    self._cond.wait(deadline)
            except BaseException:
                # the admission unwind fix: ANY exception out of the wait
                # returns the seat before re-raising
                self._waiting -= 1
                raise

    def release_seat(self):
        with self._cond:
            self._waiting -= 1
