"""The whole MLP round's share of the card's peak (``TraceData.round_mfu``):
the least time the traced rounds' work needs over the traced window, the
larger of the kept samples' forward and backward FLOPs
(``costs.mlp_train_flops``) at the configuration's compute peak (float32)
and each kept agent's posterior and Adam buffers read and written once
(``costs.posterior_adam_bytes``) at the HBM peak (``hw``)."""


def read(t):
    return t.round_mfu()
