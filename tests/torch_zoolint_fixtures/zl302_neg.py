def predict(model, x, n):
    return fetch_rows(model.dispatch_padded(x), n)  # explicit fetch


def fetch_rows(out, n):
    return out[:n]
