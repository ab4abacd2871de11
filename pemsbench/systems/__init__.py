"""The systems under test, one module each, named by a configuration's
``system`` key."""
