import threading


class Admission:
    def __init__(self):
        self._cond = threading.Condition()
        self._waiting = 0
        self._granted = False

    def acquire_seat(self, deadline):
        # the admission _acquire shape with the unwind fix reverted: the
        # seat is taken, the wait can raise (deadline lapse or a
        # KeyboardInterrupt inside Condition.wait), and nothing on
        # that path gives the seat back — max_queue shrinks forever
        with self._cond:
            self._waiting += 1
            while not self._granted:
                if deadline <= 0:
                    raise TimeoutError("deadline lapsed waiting")
                self._cond.wait(deadline)

    def release_seat(self):
        with self._cond:
            self._waiting -= 1
