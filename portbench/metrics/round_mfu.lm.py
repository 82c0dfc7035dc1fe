"""The whole LM round's share of the card's peak (``TraceData.round_mfu``):
the least time the traced rounds' work needs over the traced window, the
larger of the model FLOPs (``costs.lm_train_flops``: 6 x matmul weights a
token plus causal attention, forward and backward) at the configuration's
compute peak (bfloat16) and each posterior and Adam buffer read and
written once (``costs.posterior_adam_bytes``) at the HBM peak (``hw``)."""


def read(t):
    return t.round_mfu()
