from .dataset import CLASS_NAMES, SemanticWaymoDataset  # noqa: F401
