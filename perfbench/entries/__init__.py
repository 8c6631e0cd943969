"""The entries a cell can drive: ``train`` and ``serve``."""
