"""Plain references of the configurations, one module each, named by a
configuration file's ``reference`` key."""
