from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    SgdState,
    adam,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
    tree_map,
)

__all__ = ["AdamState", "Optimizer", "SgdState", "adam", "apply_updates", "clip_by_global_norm",
           "global_norm", "sgd", "tree_map"]
