"""Hyperparameter search over the port's training CLI (port of the
repository's ``hpo/``): ``random_search`` and its NNI-format
``search_space.json``."""
