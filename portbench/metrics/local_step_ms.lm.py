"""Time of one LM local Bayes-by-Backprop step
(``launch.steps.make_local_step`` -> ``vi.blocked_update``): CUDA events
around every local step call of the window's traced rounds, summed and
divided by the step count."""


def read(t):
    ms = t.stats.get("local_step_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
