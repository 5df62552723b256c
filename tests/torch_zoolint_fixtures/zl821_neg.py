class Engine:
    def __init__(self, store, pad_mult):
        self.store = store
        self._pad_mult = pad_mult
        self._digest = "w0"

    def _shape(self, n):
        return n * self._pad_mult

    def ensure_compiled(self, n):
        shaped = self._shape(n)
        # pad_mult is folded into the key: changing it rotates the
        # fingerprint and forces a fresh compile
        fp = self.store.fingerprint("kind", self._digest,
                                    self._pad_mult)
        return fp, shaped
