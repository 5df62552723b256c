class Router:
    def flush(self, conn, rid):
        conn.send({"op": "flush", "id": rid})

    def predict(self, conn, rid, rows):
        conn.send({"op": "predict", "id": rid, "rows": rows})


class Worker:
    def __init__(self):
        # every sent op has a handler, every handler has a sender
        self._control = {"predict": self._do_predict,
                         "flush": self._do_flush}

    def _do_predict(self, req):
        return {"id": req["id"], "ok": True}

    def _do_flush(self, req):
        return {"id": req["id"], "ok": True}
