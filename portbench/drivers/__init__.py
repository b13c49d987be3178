"""One driver per kind of traffic; ``run.py`` loads them by name."""
