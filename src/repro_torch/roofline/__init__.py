"""The port's roofline model: counterpart of ``repro.roofline``."""
