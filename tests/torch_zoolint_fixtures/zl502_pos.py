import queue

requests: "queue.Queue" = queue.Queue()  # unbounded: overload -> latency
