"""Launch entry points (counterpart of ``repro.launch``): the mesh
builders (``mesh``), the train and serve CLIs (``train``, ``serve``).
The multi-pod dry-run is not ported yet."""
