"""Mean ms a tune request spends locating its query keys
(``Workload.from_keys``: ``core.workload.locate``)."""


def read(r):
    return r.span_ms("locate", per="request")
