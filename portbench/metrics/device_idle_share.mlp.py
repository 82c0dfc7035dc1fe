"""Share of an MLP cell's traced window in which no operation ran on the
card: 1 - (union of the device operations' intervals) / (traced wall
time), over the traffic's ``profile_rounds`` (``TraceData.idle_share``)."""


def read(t):
    return t.idle_share()
