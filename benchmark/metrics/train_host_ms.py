"""The host's time in the train step's call a step (its enqueue; nothing
in it waits for the device): the mean of the benchmark's span around the
call, in ms."""


def read(r):
    d = r.spans.get("train.step")
    return 1e3 * sum(d) / len(d) if d else None
