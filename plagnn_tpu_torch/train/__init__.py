from .kfold import FOLD_SEEDS, all_round_masks, fold_node_masks  # noqa: F401
