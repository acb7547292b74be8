"""The port's sketch package: counterpart of ``repro.sketch``."""
