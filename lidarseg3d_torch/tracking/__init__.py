from .tracker import CenterTracker, greedy_assignment  # noqa: F401
