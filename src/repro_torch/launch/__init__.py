"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train``, ``.dryrun``) and the step functions (``steps``).

Two modules of the reference's ``repro.launch`` have no counterpart:
  * ``mesh.py``: the port runs on one card, with no device mesh to make;
  * ``partition.py``: with every tensor whole on that card there are no
    PartitionSpecs to assign (the mesh sizes ``steps`` needs are its own
    constants).
"""
