import queue

requests: "queue.Queue" = queue.Queue(maxsize=64)  # bounded: sheds
