import threading


def spawn(work):
    t = threading.Thread(target=work)  # non-daemon, never joined
    t.start()
    return t
