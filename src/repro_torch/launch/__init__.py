"""Launch entry points (counterpart of ``repro.launch``): the mesh
builders (``mesh``), the train and serve CLIs (``train``, ``serve``) and
the multi-pod dry-run (``dryrun``: one step of each cell traced on a
fake process group)."""
