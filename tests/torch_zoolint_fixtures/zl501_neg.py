import threading


def spawn(work):
    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t


def run_to_completion(work):
    t = threading.Thread(target=work)
    t.start()
    t.join()  # joined in-module: bounded lifetime
    return t
