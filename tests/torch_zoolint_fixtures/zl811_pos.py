def families_requests(n):
    return [Family("counter", "fx_requests_total", "requests served",
                   [(n, {"model": "default"})])]


def families_requests_elsewhere(n):
    # same family name, conflicting type: the aggregator merges these
    # two into one nonsensical series
    return [Family("gauge", "fx_requests_total", "requests served",
                   [(n, {"model": "default"})])]
