def families_requests(n):
    return [Family("counter", "fx_requests_total", "requests served",
                   [(n, {"model": "default"})])]


def families_requests_elsewhere(n):
    # same name, same type, same label schema: one family, two sites
    return [Family("counter", "fx_requests_total", "requests served",
                   [(n, {"model": "default"})])]
