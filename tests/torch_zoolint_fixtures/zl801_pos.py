class Router:
    def flush(self, conn, rid):
        # "flush" is sent but the worker's dispatch table below has
        # no entry for it — unknown-op error on the first real call
        conn.send({"op": "flush", "id": rid})

    def predict(self, conn, rid, rows):
        conn.send({"op": "predict", "id": rid, "rows": rows})


class Worker:
    def __init__(self):
        self._control = {"predict": self._do_predict}

    def _do_predict(self, req):
        return {"id": req["id"], "ok": True}
