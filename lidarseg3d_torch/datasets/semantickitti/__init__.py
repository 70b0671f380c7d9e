from . import metadata  # noqa: F401
from .dataset import SemanticKITTIDataset  # noqa: F401
