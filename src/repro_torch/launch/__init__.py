"""Launchers (counterpart of ``repro.launch``): the mesh builders. The
train and serve drivers and the multi-pod dry-run are not ported yet."""
