class Engine:
    def __init__(self, store, pad_mult):
        self.store = store
        self._pad_mult = pad_mult
        self._digest = "w0"

    def _shape(self, n):
        # constructor-derived config read on the compile path...
        return n * self._pad_mult

    def ensure_compiled(self, n):
        shaped = self._shape(n)
        # ...but the fingerprint never folds it: two engines differing
        # only in pad_mult share a store key, and the second serves
        # the first one's stale executable
        fp = self.store.fingerprint("kind", self._digest)
        return fp, shaped
