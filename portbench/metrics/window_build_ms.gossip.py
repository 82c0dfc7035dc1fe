"""Host time of the gossip engine's window build (its clock window, fault
draws and the host-to-card copies): the program's ``gossip.window_build``
span, summed over the window's traced rounds and divided by their count."""


def read(t):
    spans = [dur for name, dur in t.spans if name == "gossip.window_build"]
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3
