from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    SgdState,
    adam,
    apply_updates,
    sgd,
    tree_map,
)

__all__ = ["AdamState", "Optimizer", "SgdState", "adam", "apply_updates", "sgd", "tree_map"]
